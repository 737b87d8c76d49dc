"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA card (sm_90a) and nvcc; skips elsewhere. Imports neither JAX
nor the JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.ops import cuda_raster
from skelsplat_tpu_torch.synthetic import synthetic_inputs

W, H = 240, 200


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the CPU the wrappers run their "
                    "plain versions, which tests/test_torch_raster.py checks")


# (joints, view with no live tile)
CASES = {"n17": (17, None), "n15": (15, None), "n19": (19, None),
         "dead_view": (17, 1)}


@pytest.fixture(params=list(CASES))
def packed(card, request):
    from skelsplat_tpu_torch.tools import kernel_probe

    n, dead = CASES[request.param]
    pack, p1s, p2s, img = kernel_probe.probe_inputs(
        W, H, n_joints=n, widths=(240, 238, 240, 236), device="cuda")
    if dead is not None:
        pack, p1s = kernel_probe.keep_slots(pack, p1s, 0, views=[dead])
    return pack, p1s, p2s, img, dead


@pytest.mark.cuda
@pytest.mark.parametrize("l1", [False, True])
def test_kernels_match_plain_versions(packed, l1):
    pack, p1s, p2s, img, dead = packed
    before = dict(cuda_raster.launches)
    S, C, dg, live = cuda_raster.raster_loss_grad(pack, p1s, p2s, img, l1,
                                                  return_live=True)
    S_b, C_b, dg_b = cuda_raster.raster_loss_grad(pack, p1s, p2s, img, l1)
    S2, C2 = cuda_raster.raster_loss(pack, p1s, p2s, img, l1)
    Sp, Cp, dgp = cuda_raster.raster_loss_grad_plain(pack, p1s, p2s, img, l1)
    idx_p, mask_p, n_p = cuda_raster.live_tiles_plain(pack, H, W)
    torch.cuda.synchronize()
    assert cuda_raster.launches["raster_loss_grad"] == before["raster_loss_grad"] + 2
    assert cuda_raster.launches["raster_loss"] == before["raster_loss"] + 1
    # the kernel's live-tile list, entry for entry
    idx, mask, n = live
    assert torch.equal(n, n_p)
    for v in range(pack.shape[0]):
        k = int(n_p[v])
        assert torch.equal(idx[v, :k], idx_p[v, :k])
        assert torch.equal(mask[v, :k], mask_p[v, :k])
    # deterministic: no float atomics
    assert torch.equal(S, S_b) and torch.equal(C, C_b) and torch.equal(dg, dg_b)
    assert torch.equal(C, Cp) and torch.equal(C2, C)
    assert torch.equal(S2, S)
    live_views = [v for v in range(pack.shape[0]) if v != dead]
    assert bool((C[live_views] > 0).all())
    if dead is not None:  # set by the list kernel, exactly
        assert int(n[dead]) == 0 and float(S[dead]) == 0.0 and int(C[dead]) == 0
        assert float(dg[dead].abs().max()) == 0.0
    # only the summation order differs from the plain version; each gradient
    # component (px, py, a, b, c, opa) is held to its own scale per view
    torch.testing.assert_close(S, Sp, rtol=1e-5, atol=0)
    scale = dgp[live_views].abs().amax(dim=1, keepdim=True)
    assert bool(torch.isfinite(scale).all()) and bool((scale > 0).all())
    assert ((dg[live_views] - dgp[live_views]).abs() / scale).max().item() <= 1e-5


@pytest.mark.cuda
def test_calls_on_two_streams_overlap_safely(card):
    """A K1 call keeps its state (live list, per-view tickets, partials) in
    its own buffers: calls in flight together on two streams give bitwise
    what each gives alone."""
    from skelsplat_tpu_torch.tools import kernel_probe

    inputs = [kernel_probe.probe_inputs(W, H, seed=s, device="cuda")
              for s in (0, 1)]
    alone = [cuda_raster.raster_loss_grad(*x, False) for x in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for k, (x, stream) in enumerate(zip(inputs, streams)):
            with torch.cuda.stream(stream):
                outs[k].append(cuda_raster.raster_loss_grad(*x, False))
    torch.cuda.synchronize()
    assert not torch.equal(alone[0][0], alone[1][0])
    for k in range(2):
        for out in outs[k]:
            assert all(torch.equal(a, b) for a, b in zip(out, alone[k])), k


@pytest.mark.cuda
def test_macro_steps_make_no_host_sync(card):
    """The host waits on the device only in a scene's set-up and for its
    results: the count of synchronizing calls is the same for 2 and for 10
    macro steps."""
    import warnings

    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings

    def count_syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in caught)

    # the detector sees a sync where there is one
    assert count_syncs(lambda: torch.ones(1, device="cuda").item()) >= 1

    init, gt, p2d, cams_np = synthetic_inputs(1, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cuda")
    syncs = {}
    for iters in (8, 40):
        trainer = SceneTrainer(SkeletonModel("h36m", 17), OptConfig(iters),
                               TrainSettings(), W, H, renderer="cuda")
        trainer.optimize_scene(init[0], p2d[0], cams, gt[0])   # warm-up
        torch.cuda.synchronize()
        syncs[iters] = count_syncs(lambda: trainer.optimize_scene(
            init[0], p2d[0], cams, gt[0]))
    assert syncs[8] == syncs[40], syncs


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mul", "fma", "exp", "mix"])
def test_issue_rate_kernel_matches_plain_version(card, op):
    """K3 against its plain version, with a ragged last block: the same IEEE
    operations in the same order, so bitwise equal (an exp chain is exactly
    0 from its third step on, so for exp this checks only that the chain is
    built; chip_smoke.py's SASS count checks expf's body)."""
    from skelsplat_tpu_torch.tools import roofline

    x = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, 3 * 256 + 17),
                        dtype=torch.float32, device="cuda")
    for chains in roofline.CHAINS:
        before = roofline.launches["issue_rate"]
        got = roofline.issue_rate(x, 128, chains, op)
        ref = roofline.issue_rate_plain(x, 128, chains, op)
        torch.cuda.synchronize()
        assert roofline.launches["issue_rate"] == before + 1
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, ref), (op, chains)
