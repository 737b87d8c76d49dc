"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA card (sm_90a) and nvcc; skips elsewhere. Imports neither JAX
nor the JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.core.gaussians import init_params
from skelsplat_tpu_torch.ops import cuda_raster, heatmaps, rasterizer
from skelsplat_tpu_torch.synthetic import synthetic_inputs

W, H = 240, 200


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the CPU the wrappers run their "
                    "plain versions, which tests/test_torch_raster.py checks")


@pytest.fixture
def packed(card):
    init, _, p2d, cams_np = synthetic_inputs(1, W, H, widths=(240, 238, 240, 236))
    cams = compat.camera_from_numpy(cams_np, device="cuda")
    params = init_params(init[0], "h36m", 3.0, 1.0, device="cuda")
    spec = heatmaps.heatmap_spec(params.xyz, params.covariance(),
                                 torch.as_tensor(p2d[0], device="cuda"),
                                 cams, W, H)
    prof = cuda_raster.view_profiles(spec, W, H)
    pp = rasterizer.preprocess_gaussians(params.xyz, params.covariance(),
                                         params.opacity, cams, W, H)
    gd, aux, p1s, p2s = cuda_raster.slot_pack(pp, prof)
    return torch.cat([gd, aux], dim=-1).contiguous(), p1s, p2s, prof.img


@pytest.mark.cuda
@pytest.mark.parametrize("l1", [False, True])
def test_kernels_match_plain_versions(packed, l1):
    pack, p1s, p2s, img = packed
    before = dict(cuda_raster.launches)
    S, C, dg = cuda_raster.raster_loss_grad(pack, p1s, p2s, img, l1)
    S_b, C_b, dg_b = cuda_raster.raster_loss_grad(pack, p1s, p2s, img, l1)
    S2, C2 = cuda_raster.raster_loss(pack, p1s, p2s, img, l1)
    Sp, Cp, dgp = cuda_raster.raster_loss_grad_plain(pack, p1s, p2s, img, l1)
    torch.cuda.synchronize()
    assert cuda_raster.launches["raster_loss_grad"] == before["raster_loss_grad"] + 2
    assert cuda_raster.launches["raster_loss"] == before["raster_loss"] + 1
    # deterministic: no float atomics
    assert torch.equal(S, S_b) and torch.equal(C, C_b) and torch.equal(dg, dg_b)
    assert torch.equal(C, Cp) and torch.equal(C2, C) and bool((C > 0).all())
    assert torch.equal(S2, S)
    # only the summation order differs from the plain version; each gradient
    # component (px, py, a, b, c, opa) is held to its own scale per view
    torch.testing.assert_close(S, Sp, rtol=1e-5, atol=0)
    scale = dgp.abs().amax(dim=1, keepdim=True)
    assert bool(torch.isfinite(scale).all()) and bool((scale > 0).all())
    assert ((dg - dgp).abs() / scale).max().item() <= 1e-5


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
