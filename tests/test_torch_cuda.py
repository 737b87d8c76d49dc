"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA card (sm_90a) and nvcc; skips elsewhere. Imports neither JAX
nor the JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.ops import _build, compose_adam, cuda_raster
from skelsplat_tpu_torch.synthetic import synthetic_inputs

W, H = 240, 200


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the CPU the wrappers run their "
                    "plain versions, which tests/test_torch_raster.py checks")


WIDTHS = (240, 238, 240, 236)
# (joints, view with no live tile, scenes: a batch of 8 gives V = 32)
CASES = {"n17": (17, None, 1), "n15": (15, None, 1), "n19": (19, None, 1),
         "dead_view": (17, 1, 1), "batch_v32": (17, None, 8)}


@pytest.fixture(params=list(CASES))
def packed(card, request):
    from skelsplat_tpu_torch.tools import kernel_probe

    n, dead, scenes = CASES[request.param]
    if scenes > 1:
        pack, p1s, p2s, img = kernel_probe.probe_inputs_batch(
            scenes, W, H, widths=WIDTHS, perturb=True, device="cuda")
        assert pack.shape[0] == 4 * scenes
    else:
        pack, p1s, p2s, img = kernel_probe.probe_inputs(
            W, H, n_joints=n, widths=WIDTHS, device="cuda")
    if dead is not None:
        pack, p1s = kernel_probe.keep_slots(pack, p1s, 0, views=[dead])
    return pack, p1s, p2s, img, dead


@pytest.mark.cuda
@pytest.mark.parametrize("l1", [False, True])
def test_kernels_match_plain_versions(packed, l1):
    pack, p1s, p2s, img, dead = packed
    before = _build.launch_counts()
    S, C, dg, live = cuda_raster.raster_loss_grad(pack, p1s, p2s, img, l1,
                                                  return_live=True)
    S_b, C_b, dg_b = cuda_raster.raster_loss_grad(pack, p1s, p2s, img, l1)
    S2, C2 = cuda_raster.raster_loss(pack, p1s, p2s, img, l1)
    Sp, Cp, dgp = cuda_raster.raster_loss_grad_plain(pack, p1s, p2s, img, l1)
    idx_p, mask_p, n_p = cuda_raster.live_tiles_plain(pack, H, W)
    torch.cuda.synchronize()
    launched = _build.launch_counts(since=before)
    assert launched["raster_loss_grad"] == 2
    assert launched["raster_loss"] == 1
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


# K1 for every run length: (W, H, joints, widths, kind) at each cell's
# frame size and a small ragged 19-joint rig. Kinds: "short" lists, view 0
# keeping one slot (a list shorter than the longest runs) and view 1 none;
# "one_point", every joint at one point, so that some tiles flag every slot
# (N = 15, 19 and 25: slot bounds 16, 24 and 32); "gt_only", view 2's
# splats at zero opacity, so that its tiles flag GT slots alone. The last
# two are also held to the plain version.
RUN_CASES = {"h36m": (1002, 1000, 17, None, None),
             "panoptic": (1920, 1080, 19, None, None),
             "n19_ragged": (W, H, 19, WIDTHS, None),
             "short_lists": (1002, 1000, 17, None, "short"),
             "one_point_n15": (1002, 1000, 15, None, "one_point"),
             "one_point_n19": (1002, 1000, 19, None, "one_point"),
             "one_point_n25": (1002, 1000, 25, None, "one_point"),
             "gt_only": (1002, 1000, 17, None, "gt_only")}
RUNS = (1, 2, 4, 8, 32, cuda_raster.MAX_RUN)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RUN_CASES))
def test_k1_is_bitwise_across_run_lengths(card, case):
    """K1's S, C and dg (and K2's S and C) are the same bits for every run
    length R: each list entry's partials and each view's sum keep their
    order whatever run the entry falls in. Lists here end in a part run
    (their lengths are not multiples of R)."""
    from skelsplat_tpu_torch.tools import kernel_probe

    w, h, n, widths, kind = RUN_CASES[case]
    pack, p1s, p2s, img = kernel_probe.probe_inputs(
        w, h, n_joints=n, widths=widths, perturb=True,
        one_point=kind == "one_point", device="cuda")
    if kind == "short":
        pack, p1s = kernel_probe.keep_slots(pack, p1s, 1, views=[0])
        pack, p1s = kernel_probe.keep_slots(pack, p1s, 0, views=[1])
    if kind == "gt_only":
        pack = pack.clone()
        pack[2, :, cuda_raster.IDX_OPA] = 0.0
    outs = {R: cuda_raster._launch(pack, p1s, p2s, img, False, True, run=R)
            for R in RUNS}
    k2 = {R: cuda_raster._launch(pack, p1s, p2s, img, False, False, run=R)
          for R in (1, 3, 16)}
    default = cuda_raster.raster_loss_grad(pack, p1s, p2s, img, False)
    torch.cuda.synchronize()
    ref = outs[1][:3]
    live_n = outs[1][3][2].tolist()
    assert any(L % R for L in live_n for R in RUNS if L > R), live_n
    for R, out in outs.items():
        assert _same(out[:3], ref), R
    assert _same(default, ref)
    for R, out in k2.items():
        assert _same(out[:2], ref[:2]), R
    if kind == "short":
        assert 0 < live_n[0] < 32 and live_n[1] == 0, live_n
        assert float(ref[0][1]) == 0.0 and int(ref[1][1]) == 0
        assert float(ref[2][1].abs().max()) == 0.0
    else:
        assert min(live_n) > 0, live_n
    if kind in ("one_point", "gt_only"):
        mask = outs[1][3][1]
        rend = [mask[v, :L] & 0xFFFFFFFF for v, L in enumerate(live_n)]
        if kind == "one_point":  # some tile flags every slot for render
            assert any(bool((r == (1 << n) - 1).any()) for r in rend)
        else:  # view 2 flags no render slot, has GT terms and no gradient
            assert not bool(rend[2].any()) and int(ref[1][2]) > 0
            assert float(ref[2][2].abs().max()) == 0.0
        S, C, dg = ref
        Sp, Cp, dgp = cuda_raster.raster_loss_grad_plain(pack, p1s, p2s, img,
                                                         False)
        assert torch.equal(C, Cp)
        torch.testing.assert_close(S, Sp, rtol=1e-5, atol=0)
        scale = dgp.abs().amax(dim=1, keepdim=True)
        assert bool(((dg - dgp).abs() <= 1e-5 * scale).all())


@pytest.mark.cuda
def test_k1_batch_is_bitwise_each_scenes_own_call(card):
    """One K1 launch over 128 Panoptic scenes' 512 views (the batch's long
    runs) gives every scene the bits of its own 4-view launch (the
    chain's short runs)."""
    from skelsplat_tpu_torch.tools import kernel_probe

    parts = [kernel_probe.probe_inputs(1920, 1080, n_joints=19, seed=s,
                                       device="cuda") for s in range(128)]
    batch = tuple(torch.cat(xs).contiguous() for xs in zip(*parts))
    grid = cuda_raster.persistent_grid(torch.cuda.current_device(), True,
                                       False, 19)
    assert cuda_raster.run_length(512, 120 * 68, grid) \
        > cuda_raster.run_length(4, 120 * 68, grid)
    S, C, dg = cuda_raster.raster_loss_grad(*batch, False)
    for s, x in enumerate(parts):
        own = cuda_raster.raster_loss_grad(*x, False)
        assert _same(own, (S[4 * s:4 * s + 4], C[4 * s:4 * s + 4],
                           dg[4 * s:4 * s + 4])), s


# kernels A and B at each cell's shapes (scene type, scenes, W, H) and
# small ones: antialiasing, a culled Gaussian, one past the EWA clamp, an
# infinite opacity logit
STEP_CASES = {
    "h36m": ("h36m", 1, 1002, 1000, False, None),
    "panoptic": ("panoptic", 1, 1920, 1080, False, None),
    "batch8": ("h36m", 8, 1002, 1000, False, None),
    "antialiasing": ("occlusion-person", 3, W, H, True, None),
    "behind_camera": ("h36m", 3, W, H, False, "behind_camera"),
    "beyond_clamp": ("h36m", 3, W, H, True, "beyond_clamp"),
    "infinite_logit": ("panoptic", 3, W, H, False, "infinite_logit"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_preprocess_kernels_match_plain_versions(card, case):
    """Kernel A's slot records (order, rect and every float), order and
    gathered profiles bitwise its plain version's on the card; kernel B's
    losses and gradients, from the same K1 outputs, within 1e-5 of each
    field's largest magnitude of the plain backward's; one launch each."""
    from skelsplat_tpu_torch.core.gaussians import PARAM_FIELDS
    from skelsplat_tpu_torch.ops import cuda_preprocess as cp
    from skelsplat_tpu_torch.tools.kernel_probe import step_inputs

    st, ns, w, h, aa, special = STEP_CASES[case]
    params, cams, prof, A = step_inputs(
        st, ns, w, h, device="cuda", **({special: True} if special else {}))
    limbs = cp.limb_pairs("3D_length_consistency", st)
    before = _build.launch_counts()
    pack, order, p1s, p2s = cp.preprocess_pack(params, cams, prof, A, aa)
    S, C, dg = cuda_raster.raster_loss_grad(pack, p1s, p2s, prof.img, False)
    losses, grads = cp.preprocess_grad(params, cams, order, S, C, dg, A, w,
                                       h, aa, limbs, 1e-2)
    torch.cuda.synchronize()
    assert _build.launch_counts(since=before) == {
        "raster_loss_grad": 1, "raster_loss": 0, "preprocess_pack": 1,
        "preprocess_grad": 1, "compose_adam": 0, "issue_rate": 0}
    for got, want in zip((pack, order, p1s, p2s),
                         cp.preprocess_pack_plain(params, cams, prof, A, aa)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    ref_losses, ref = cp.preprocess_grad_plain(params, cams, order, S, C, dg,
                                               A, w, h, aa, limbs, 1e-2)
    pairs = [(losses, ref_losses)] + [(getattr(grads, f), getattr(ref, f))
                                      for f in PARAM_FIELDS]
    for got, want in pairs:
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    if special == "infinite_logit":
        assert float(grads.opacity_logit.abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_preprocess_grad_matches_autograd(card, case):
    """Kernel B's losses and gradients, after kernel A and K1, within 1e-5
    of each field's largest magnitude of the step they replaced on the
    card: autograd of ``make_cuda_view_loss`` with one parameter copy per
    view (``kernel_probe.autograd_step``)."""
    from skelsplat_tpu_torch.core.gaussians import PARAM_FIELDS
    from skelsplat_tpu_torch.ops import cuda_preprocess as cp
    from skelsplat_tpu_torch.tools.kernel_probe import (autograd_step,
                                                        step_inputs)

    st, ns, w, h, aa, special = STEP_CASES[case]
    params, cams, prof, A = step_inputs(
        st, ns, w, h, device="cuda", **({special: True} if special else {}))
    cons = "3D_length_consistency"
    fwd = cp.view_forward(params, cams, prof, A, aa)
    losses, grads = cp.preprocess_grad(params, cams, *fwd, A, w, h, aa,
                                       cp.limb_pairs(cons, st), 1e-2)
    ref_losses, ref = autograd_step(params, cams, prof, A, aa, "l2_gaussian",
                                    st, cons, 1e-2)
    pairs = [(losses, ref_losses)] + [(getattr(grads, f), ref[f])
                                      for f in PARAM_FIELDS]
    for got, want in pairs:
        assert got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# kernel C at each cell's macro step: (scene axes, joints, optimizer
# settings): h36m.chain32's, panoptic.chain32's and panoptic.batch128's
# (128 scenes, 512 views), and a delayed xyz schedule with rotation at LR 0
ADAM_CASES = {
    "h36m": ((), 17, {}),
    "panoptic": ((), 19, {"position_lr_init": 5e-3, "opacity_lr": 5e-3}),
    "batch512": ((128,), 19, {"position_lr_init": 5e-3,
                              "opacity_lr": 5e-3}),
    "delayed": ((3,), 15, {"position_lr_delay_steps": 300,
                           "position_lr_delay_mult": 0.01,
                           "rotation_lr": 0.0}),
}
NORM_ULPS = compose_adam.NORM_ULPS


def _ulps(a, b) -> int:
    """The largest distance of two non-negative float32 tensors in units
    in the last place."""
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False])
@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_compose_adam_matches_torch_composite(card, case, lean):
    """Kernel C against the torch composite it replaces (``compose_macro``
    and ``record_step``) on the card, over all 125 macro steps of a
    scene from the same state and gradients: parameters, moments, step
    counts, the step counter, the losses rows and the stop fields bitwise
    after every step; the telemetry norms within NORM_ULPS; one launch a
    step."""
    import numpy as np

    from skelsplat_tpu_torch.core.gaussians import (GaussianParams,
                                                    SkeletonModel)
    from skelsplat_tpu_torch.engine import trainer as ttrainer
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings
    from skelsplat_tpu_torch.utils import tree_leaves

    lead, n, opt = ADAM_CASES[case]
    A = 4
    scene_type = {17: "h36m", 19: "panoptic", 15: "occlusion-person"}[n]
    tr = SceneTrainer(SkeletonModel(scene_type, n),
                      OptConfig(**opt), TrainSettings(), W, H,
                      renderer="cuda", eager=True)
    rng = np.random.default_rng(11)

    def cuda(x):
        return torch.from_numpy(np.asarray(x, np.float32)).cuda()

    widths = (3, 3, 4, 1)
    params = GaussianParams(*(cuda(rng.normal(0.0, 1.0, lead + (n, w)))
                              for w in widths))
    gt = cuda(rng.normal(0.0, 300.0, lead + (n, 3)))
    extent = cuda(rng.uniform(500.0, 5000.0, lead))
    st_c = tr._loop_state(params, A, None, lean)
    st_t = tr._loop_state(params, A, None, lean)
    norms = [] if lean else [(st_c.error, st_t.error),
                             (st_c.error_rel, st_t.error_rel)]
    exact = [(a, b) for a, b in zip(tree_leaves(st_c), tree_leaves(st_t))
             if all(a is not x for x, _ in norms)]
    worst = 0
    for k in range(tr.n_macro):
        losses_v = cuda(rng.uniform(0.1, 2.0, lead + (A,)))
        grads_v = GaussianParams(*(
            cuda(rng.normal(0.0, 1.0, lead + (A, n, w))
                 * 10.0 ** rng.uniform(-4, 1, lead + (A, n, w)))
            for w in widths))
        before = _build.launch_counts()
        ttrainer.compose_adam_step(tr.adam, st_c, losses_v, grads_v, gt,
                                   extent, lean)
        assert _build.launch_counts(since=before)["compose_adam"] == 1
        carry, rec = ttrainer.compose_macro(
            tr.adam, A, False, False, st_t.carry, st_t.step, losses_v,
            grads_v, None, gt, extent, lean=lean)
        ttrainer.record_step(st_t, carry, rec, lean)
        for i, (a, b) in enumerate(exact):
            assert a.dtype == b.dtype and torch.equal(a, b), (k, i)
        for a, b in norms:
            worst = max(worst, _ulps(a, b))
    assert int(st_c.step) == tr.n_macro
    assert worst <= NORM_ULPS, worst


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [True, False])
def test_kernel_c_scene_matches_torch_composite(card, lean, monkeypatch):
    """A captured scene of 500 iterations through kernel C against the
    same scene with the routing sent to the torch composite: parameters
    and losses bitwise, the telemetry norms within NORM_ULPS; 125 launches
    of kernel C, and none on the torch route."""
    from skelsplat_tpu_torch.engine import trainer as ttrainer

    init, gt, p2d, cams_np = synthetic_inputs(1, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    results, counts = {}, {}
    for route in ("kernel_c", "torch"):
        if route == "torch":
            monkeypatch.setattr(ttrainer, "adam_kernel_serves",
                                lambda settings, nviews: False)
        tr = _trainer(500)
        before = _build.launch_counts()
        results[route] = tr.optimize_scene(init[0], p2d[0], cams, gt[0],
                                           lean=lean)
        torch.cuda.synchronize()
        counts[route] = _build.launch_counts(since=before)["compose_adam"]
    assert counts == {"kernel_c": 125, "torch": 0}
    (p_c, h_c), (p_t, h_t) = results["kernel_c"], results["torch"]
    _assert_same(p_c, p_t)
    for f in ("losses", "stopped_at"):
        assert torch.equal(getattr(h_c, f), getattr(h_t, f)), f
    for f in ("error", "error_rel"):
        assert _ulps(getattr(h_c, f), getattr(h_t, f)) <= NORM_ULPS, f


@pytest.mark.cuda
def test_compose_adam_on_two_streams(card):
    """Kernel C keeps its count of finished blocks in the caller's step
    counter: two batches of 128 scenes, each with its own loop state,
    stepped 125 times on two streams in flight together, end bitwise where
    each ends alone, with their counters at 125."""
    import numpy as np

    from skelsplat_tpu_torch.core.gaussians import (GaussianParams,
                                                    SkeletonModel)
    from skelsplat_tpu_torch.engine import trainer as ttrainer
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings

    A, n, lead = 4, 19, (128,)
    tr = SceneTrainer(SkeletonModel("panoptic", n), OptConfig(),
                      TrainSettings(), W, H, renderer="cuda", eager=True)
    rng = np.random.default_rng(5)

    def cuda(x):
        return torch.from_numpy(np.asarray(x, np.float32)).cuda()

    widths = (3, 3, 4, 1)
    batches = []
    for _ in range(2):
        params = GaussianParams(*(cuda(rng.normal(0.0, 1.0, lead + (n, w)))
                                  for w in widths))
        losses_v = cuda(rng.uniform(0.1, 2.0, lead + (A,)))
        grads_v = GaussianParams(*(cuda(rng.normal(0.0, 1.0,
                                                   lead + (A, n, w)))
                                   for w in widths))
        gt = cuda(rng.normal(0.0, 300.0, lead + (n, 3)))
        extent = cuda(rng.uniform(500.0, 5000.0, lead))
        batches.append((params, (losses_v, grads_v, gt, extent)))

    def run(streams):
        states = [tr._loop_state(p, A, None, True) for p, _ in batches]
        torch.cuda.synchronize()
        for _ in range(tr.n_macro):
            for st, (_, args), stream in zip(states, batches, streams):
                with torch.cuda.stream(stream):
                    ttrainer.compose_adam_step(tr.adam, st, *args, True)
        torch.cuda.synchronize()
        return states

    alone = run([torch.cuda.current_stream()] * 2)
    together = run([torch.cuda.Stream() for _ in batches])
    for a, b in zip(alone, together):
        assert int(b.step) == tr.n_macro
        _assert_same(a, b)


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


def _replays(kind):
    """The graph replays of programs of ``kind`` so far, by the tracing
    module's ``graph_launches`` counter."""
    from skelsplat_tpu_torch import tracing

    return tracing.counters["graph_launches"][kind]


def _count_syncs(fn):
    """The synchronizing CUDA calls ``fn`` makes, by torch's detector (its
    warnings, not the notice it gives once a process, on first use, that
    the mode is a prototype)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


@pytest.mark.cuda
def test_macro_steps_make_no_host_sync(card):
    """The host waits on the device only in a scene's set-up and for its
    results: the count of synchronizing calls is the same for 2 and for 10
    macro steps."""
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings

    # the detector sees a sync where there is one
    assert _count_syncs(lambda: torch.ones(1, device="cuda").item()) >= 1

    init, gt, p2d, cams_np = synthetic_inputs(1, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cuda")
    syncs = {}
    for iters in (8, 40):
        trainer = SceneTrainer(SkeletonModel("h36m", 17), OptConfig(iters),
                               TrainSettings(), W, H, renderer="cuda")
        trainer.optimize_scene(init[0], p2d[0], cams, gt[0])   # warm-up
        torch.cuda.synchronize()
        syncs[iters] = _count_syncs(lambda: trainer.optimize_scene(
            init[0], p2d[0], cams, gt[0]))
    assert syncs[8] == syncs[40], syncs


@pytest.mark.cuda
def test_batched_macro_steps_make_no_host_sync(card):
    """optimize_scene_batch over 3 scenes waits on the device as often for
    2 macro steps as for 10: only in the batch's set-up and for its
    results."""
    from skelsplat_tpu_torch.core.cameras import stack_cameras
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings

    init, gt, p2d, cams_np = synthetic_inputs(3, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    cams_b = stack_cameras([cams] * 3)
    syncs = {}
    for iters in (8, 40):
        trainer = SceneTrainer(SkeletonModel("h36m", 17), OptConfig(iters),
                               TrainSettings(), W, H, renderer="cuda")
        trainer.optimize_scene_batch(init, p2d, cams_b, gt)   # warm-up
        torch.cuda.synchronize()
        syncs[iters] = _count_syncs(lambda: trainer.optimize_scene_batch(
            init, p2d, cams_b, gt))
    assert syncs[8] == syncs[40], syncs


def _trainer(iters, eager=False, renderer="cuda", debug=False, **settings):
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings

    return SceneTrainer(SkeletonModel("h36m", 17), OptConfig(iters),
                        TrainSettings(**settings), W, H, renderer=renderer,
                        eager=eager, debug=debug)


def _assert_same(a, b):
    """Every tensor of two (params, MacroHistory) results bitwise equal."""
    from skelsplat_tpu_torch.utils import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and torch.equal(x, y)


# (settings, run options): early stopping that fires (every window
# "repeats" at a tolerance of 1e6), lean telemetry, A != V with a
# checkpoint mid-run, and pipeline.debug's finite check between replays
CAPTURE_CASES = {
    "stop": ({"accumulation_steps": 4,
              "early_stopping": "opt_early_stopping"}, {}),
    "lean": ({"accumulation_steps": 4}, {"lean": True}),
    "a_ne_v_checkpoint": ({"accumulation_steps": 3}, {"checkpoint": True}),
    "debug": ({"accumulation_steps": 4, "debug": True}, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_captured_scene_matches_eager(card, case, monkeypatch):
    """optimize_scene through the captured step graph is bitwise the eager
    loop, for the scene that captures the graph and for a later scene that
    replays it from the first step; checkpoints are the eager ones too."""
    import skelsplat_tpu_torch.engine.trainer as trainer_mod

    settings, opts = CAPTURE_CASES[case]
    if case == "stop":
        monkeypatch.setattr(trainer_mod, "REPEAT_TOL", 1e6)
    init, gt, p2d, cams_np = synthetic_inputs(2, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    runs = {}
    steps = _replays("step")
    for eager in (True, False):
        tr = _trainer(48, eager=eager, **settings)
        h8, out = None, []
        for s in range(2):
            saves = []
            res = tr.optimize_scene(
                init[s], p2d[s], cams, gt[s], lean=opts.get("lean", False),
                hist8_init=h8,
                checkpoint_iterations=[12, 24] if opts.get("checkpoint")
                else (),
                checkpoint_fn=lambda it, p, saves=saves: saves.append((it, p)))
            h8 = res[1].hist8
            out.append((res, saves))
        runs[eager] = (tr, out)
    tr, captured = runs[False]
    assert tr.captures and len(tr.graphs) == 1
    graph = next(iter(tr.graphs.values()))
    assert graph.nodes > 0
    assert _replays("step") - steps == 2 * tr.n_macro - 3
    for s, ((res_e, saves_e), (res_c, saves_c)) in enumerate(
            zip(runs[True][1], captured)):
        _assert_same(res_c, res_e)
        assert [it for it, _ in saves_c] == [it for it, _ in saves_e]
        _assert_same([p for _, p in saves_c], [p for _, p in saves_e])
        if case == "stop":   # the second scene starts from a full window
            assert int(res_c[1].stopped_at) == (8 if s == 0 else 1)
        if opts.get("checkpoint"):
            assert [it for it, _ in saves_c] == [12, 24]


# the renderers' scenes, each with a loss it implements: dense with a
# soft-argmax loss, the path renderer "auto" sends those losses through
RENDERER_LOSSES = {"cuda": "l2_gaussian", "fused": "l2_gaussian",
                   "dense": "l1_masked_huber"}


@pytest.mark.cuda
@pytest.mark.parametrize("renderer", ["fused", "dense"])
def test_fused_and_dense_renderers_stay_eager(card, renderer):
    """With eager=True the fused and dense renderers' steps run op by op
    (no graph); without it their scenes are replays of a captured step,
    and xyz and the history after 6 macro steps (3 warm-up steps, the
    capture and 2 replays) are bitwise the eager trainer's, for one scene
    and for a batch of 2 (a second graph)."""
    from skelsplat_tpu_torch.core.cameras import stack_cameras

    init, gt, p2d, cams_np = synthetic_inputs(2, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    trainers = [_trainer(24, eager=eager, renderer=renderer,
                         loss_function=RENDERER_LOSSES[renderer])
                for eager in (True, False)]
    steps = _replays("step")
    out = [t.optimize_scene(init[0], p2d[0], cams, gt[0]) for t in trainers]
    assert not trainers[0].captures and not trainers[0].graphs
    assert trainers[1].captures and len(trainers[1].graphs) == 1
    graph = next(iter(trainers[1].graphs.values()))
    assert graph.nodes > 0
    assert _replays("step") - steps == trainers[1].n_macro - 3
    _assert_same(out[1], out[0])
    batch = [t.optimize_scene_batch(init, p2d, stack_cameras([cams] * 2), gt)
             for t in trainers]
    assert len(trainers[1].graphs) == 2 and not trainers[0].graphs
    _assert_same(batch[1], batch[0])


@pytest.mark.cuda
def test_every_renderer_captures_on_the_card(card):
    """``captures`` is the one rule: true on the card for the three
    renderers, false with eager=True and on the CPU."""
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings

    for renderer, loss in RENDERER_LOSSES.items():
        for device, eager, want in (("cuda", False, True),
                                    ("cuda", True, False),
                                    ("cpu", False, False)):
            tr = SceneTrainer(SkeletonModel("h36m", 17), OptConfig(8),
                              TrainSettings(loss_function=loss), W, H,
                              renderer=renderer, device=device, eager=eager)
            assert tr.captures is want, (renderer, device, eager)


def _one_macro_step(tr, init, p2d, cams, gt):
    """A scene's prepared loop state and its macro step, as the eager loop
    runs it."""
    from skelsplat_tpu_torch.utils import put_trees

    init, p2d, cams, gt, drop, extent = put_trees(
        [tr.host_inputs(init, p2d, cams, gt)], tr.device)[0]
    params, aux = tr._prepare(init, p2d, cams, drop)
    nviews = p2d.shape[0]
    state = tr._loop_state(params, nviews, None, False)
    step = tr._step_fn(tr._visited_grads(cams, aux, p2d, 1, nviews), nviews,
                       gt, extent, False)
    return lambda: step(state)


@pytest.mark.cuda
@pytest.mark.parametrize("renderer", list(RENDERER_LOSSES))
def test_macro_step_of_each_renderer_makes_no_host_sync(card, renderer):
    """One eager macro step of each renderer under the sync detector's
    "error" mode (a sync raises), after one step that sets up autograd;
    then 10 replays of the captured step make no synchronizing call."""
    init, gt, p2d, cams_np = synthetic_inputs(1, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    loss = RENDERER_LOSSES[renderer]
    step = _one_macro_step(_trainer(40, eager=True, renderer=renderer,
                                    loss_function=loss),
                           init[0], p2d[0], cams, gt[0])
    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tr = _trainer(40, renderer=renderer, loss_function=loss)
    tr.optimize_scene(init[0], p2d[0], cams, gt[0])
    graph = next(iter(tr.graphs.values()))
    graph.state.step.zero_()
    torch.cuda.synchronize()
    assert _count_syncs(lambda: [graph.step() for _ in range(10)]) == 0


@pytest.mark.cuda
def test_captured_batch_matches_eager(card):
    """optimize_scene_batch through its batch shape's graph is bitwise
    the eager batch; a tail batch of another size is another graph."""
    from skelsplat_tpu_torch.core.cameras import stack_cameras

    init, gt, p2d, cams_np = synthetic_inputs(3, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    out = {}
    for eager in (True, False):
        tr = _trainer(40, eager=eager)
        out[eager] = [tr.optimize_scene_batch(init[:b], p2d[:b],
                                              stack_cameras([cams] * b),
                                              gt[:b]) for b in (3, 2, 3)]
        if not eager:
            assert len(tr.graphs) == 2
    for a, b in zip(out[False], out[True]):
        _assert_same(a, b)


@pytest.mark.cuda
def test_captured_chain_matches_serial_loop(card):
    """A 3-scene chain of captured replays is bitwise the eager serial
    loop with the early-stop window carried, and its launch count is
    n_macro per scene."""
    init, gt, p2d, cams_np = synthetic_inputs(3, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    kw = {"early_stopping": "opt_early_stopping"}
    eager = _trainer(40, eager=True, **kw)
    h8, serial = None, []
    for s in range(3):
        res = eager.optimize_scene(init[s], p2d[s], cams, gt[s],
                                   hist8_init=h8)
        h8 = res[1].hist8
        serial.append(res)
    tr = _trainer(40, **kw)
    hins = [tr.host_inputs(init[s], p2d[s], cams, gt[s]) for s in range(3)]
    tr.optimize_scene_chain(hins)     # captures the graph
    torch.cuda.synchronize()
    before = _build.launch_counts()
    pg, hg = tr.optimize_scene_chain(hins)
    torch.cuda.synchronize()
    assert _build.launch_counts(since=before)["raster_loss_grad"] == \
        3 * tr.n_macro
    for s, (ps, hs) in enumerate(serial):
        for f in ("xyz", "log_scales", "quats", "opacity_logit"):
            assert torch.equal(getattr(pg, f)[s], getattr(ps, f))
        assert torch.equal(hg.losses[s], hs.losses)
        assert torch.equal(hg.error[s], hs.error)
        assert torch.equal(hg.stopped_at[s], hs.stopped_at)
    assert torch.equal(hg.hist8, h8)


@pytest.mark.cuda
def test_warm_chain_and_batch_make_no_host_sync(card):
    """A warm optimize_scene_chain of 3 scenes (early stopping, the window
    carried) and a warm optimize_scene_batch of 3 make no synchronizing
    call: under the sync detector's "error" mode a sync raises. Each call
    is the group copy, then graph launches only (prepare, steps and the
    chain's collect)."""
    from skelsplat_tpu_torch.core.cameras import stack_cameras

    init, gt, p2d, cams_np = synthetic_inputs(3, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    cams_b = stack_cameras([cams] * 3)
    tr = _trainer(40, early_stopping="opt_early_stopping")
    hins = [tr.host_inputs(init[s], p2d[s], cams, gt[s]) for s in range(3)]
    for _ in range(2):      # warm-up steps, then the captures
        tr.optimize_scene_chain(hins)
        tr.optimize_scene_batch(init, p2d, cams_b, gt)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chain = tr.optimize_scene_chain(hins)
        batch = tr.optimize_scene_batch(init, p2d, cams_b, gt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert chain[0].xyz.shape == batch[0].xyz.shape == (3, 17, 3)
    for graph in tr.graphs.values():
        assert graph.prepare_program.graph is not None
        assert graph.prepare_program.nodes > 0


@pytest.mark.cuda
@pytest.mark.parametrize("renderer", list(RENDERER_LOSSES))
def test_captured_prepare_matches_eager(card, renderer):
    """Each renderer's captured prepare, replayed for each scene of a
    chain's group buffers, writes the step's inputs and loop state bitwise
    the eager _prepare and _loop_state of that scene."""
    from skelsplat_tpu_torch.utils import put_trees

    init, gt, p2d, cams_np = synthetic_inputs(3, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    loss = RENDERER_LOSSES[renderer]
    tr = _trainer(8, renderer=renderer, loss_function=loss)
    eager = _trainer(8, eager=True, renderer=renderer, loss_function=loss)
    hins = [tr.host_inputs(init[s], p2d[s], cams, gt[s]) for s in range(3)]
    prepares = _replays("prepare")
    tr.optimize_scene_chain(hins)   # scene 0 prepares eagerly, 1-2 replay
    (graph,) = tr.graphs.values()
    assert _replays("prepare") - prepares == 2
    for s in range(3):
        graph.scene.fill_(s)
        graph.prepare()
        init_d, p2d_d, cams_d, gt_d, drop_d, ext_d = put_trees(
            [hins[s]], "cuda")[0]
        params, aux = eager._prepare(init_d, p2d_d, cams_d, drop_d)
        state = eager._loop_state(params, 4, None, False)
        _assert_same((aux, p2d_d, gt_d, ext_d),
                     tuple(graph.inputs[i] for i in (1, 2, 3, 4)))
        _assert_same(state, graph.state)
    assert _replays("prepare") - prepares == 5


@pytest.mark.cuda
@pytest.mark.parametrize("nviews", [4, 3])
def test_batch_prepare_is_the_loop_on_the_card(card, nviews):
    """The vectorized prepare of 8 scenes is bitwise each scene's own
    _prepare on the card, for each renderer, at 4 views (each scene's
    block of GT taps at the loop's 16-byte alignment anyway) and at 3 (it
    would not be: the taps are laid out per scene at 512-byte
    boundaries)."""
    from skelsplat_tpu_torch.core.cameras import stack_cameras

    B = 8
    init, gt, p2d, cams_np = synthetic_inputs(B, W, H, n_views=nviews)
    cams = compat.camera_from_numpy(cams_np, device="cuda")
    init_d = torch.as_tensor(init, device="cuda")
    p2d_d = torch.as_tensor(p2d, device="cuda")
    drop = torch.zeros((B, nviews, 17), dtype=torch.bool, device="cuda")
    drop[::3, 1, 4] = True
    for renderer, loss in RENDERER_LOSSES.items():
        tr = _trainer(8, eager=True, renderer=renderer, loss_function=loss)
        params_b, aux_b = tr._prepare_batch(init_d, p2d_d,
                                            stack_cameras([cams] * B), drop)
        for b in range(B):
            params, aux = tr._prepare(init_d[b], p2d_d[b], cams, drop[b])
            rows = slice(b * nviews, (b + 1) * nviews)
            _assert_same(params_b.map(lambda x, b=b: x[b]), params)
            if isinstance(aux, torch.Tensor):
                _assert_same(aux_b[rows], aux)
            else:
                _assert_same(aux_b.take(rows), aux)


@pytest.mark.cuda
def test_chain_returns_before_its_device_work_ends(card):
    """A warm chain of 4 scenes returns to the host while its device work
    still runs: the call's host time is well under the group's device
    time, as the driver's grouped sweep needs to load and write behind
    it."""
    import time

    init, gt, p2d, cams_np = synthetic_inputs(4, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    tr = _trainer(500)
    hins = [tr.host_inputs(init[s], p2d[s], cams, gt[s]) for s in range(4)]
    tr.optimize_scene_chain(hins)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    tr.optimize_scene_chain(hins)
    host_s = time.perf_counter() - t0
    still_running = not torch.cuda.current_stream().query()
    end.record()
    torch.cuda.synchronize()
    device_s = start.elapsed_time(end) / 1e3
    assert still_running, (host_s, device_s)
    assert host_s < 0.5 * device_s, (host_s, device_s)


@pytest.mark.cuda
def test_replays_make_no_host_sync_and_count_k1(card):
    """A replay waits on nothing: 20 steps of a captured graph make no
    synchronizing call, and each adds the graph's one launch of K1 and of
    kernels A, B and C; a scene of 500 iterations counts 125 of each, the
    first one (which warms up and captures its graph) too."""
    from skelsplat_tpu_torch.ops import cuda_raster as cr

    init, gt, p2d, cams_np = synthetic_inputs(2, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    tr = _trainer(500)
    for s in range(2):
        torch.cuda.synchronize()
        before = _build.launch_counts()
        tr.optimize_scene(init[s], p2d[s], cams, gt[s])
        torch.cuda.synchronize()
        assert _build.launch_counts(since=before) == {
            "raster_loss_grad": 125, "raster_loss": 0, "preprocess_pack": 125,
            "preprocess_grad": 125, "compose_adam": 125, "issue_rate": 0}
    graph = next(iter(tr.graphs.values()))
    R = cr.run_length(4, -(-W // 16) * -(-H // 16), cr.persistent_grid(
        torch.cuda.current_device(), True, False, 17))
    # what one replay counts: its graph launch, one launch of K1 and of
    # kernels A, B and C, and one K1 call at run length R
    assert graph.step_program.credit.counts == {
        ("graph_launches", "step"): 1,
        ("kernel_launches", "raster_loss_grad"): 1,
        ("kernel_launches", "preprocess_pack"): 1,
        ("kernel_launches", "preprocess_grad"): 1,
        ("kernel_launches", "compose_adam"): 1, ("k1_run_length", str(R)): 1}
    graph.state.step.zero_()     # 20 more steps from the first
    torch.cuda.synchronize()
    before = _build.launch_counts()
    assert _count_syncs(lambda: [graph.step() for _ in range(20)]) == 0
    torch.cuda.synchronize()
    assert _build.launch_counts(since=before) == {
        "raster_loss_grad": 20, "raster_loss": 0, "preprocess_pack": 20,
        "preprocess_grad": 20, "compose_adam": 20, "issue_rate": 0}


@pytest.mark.cuda
def test_warm_chain_counts_its_graph_launches_and_device_intervals(card):
    """A warm chain of 2 scenes of 500 iterations launches 127 graphs a
    scene (its prepare, 125 steps and its collect), each step crediting
    one launch of K1 and of kernels A, B and C and one K1 call at the
    run length of its shape, and the tracing module reads
    each scene's device interval and the gap before it from its events;
    with detail on, each replay is a record with its own interval, inside
    its scene's, and the results are bitwise those with it off."""
    from skelsplat_tpu_torch.ops import cuda_raster as cr
    import time

    from skelsplat_tpu_torch import tracing

    init, gt, p2d, cams_np = synthetic_inputs(2, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    tr = _trainer(500)
    R = cr.run_length(4, -(-W // 16) * -(-H // 16), cr.persistent_grid(
        torch.cuda.current_device(), True, False, 17))
    hins = [tr.host_inputs(init[s], p2d[s], cams, gt[s]) for s in range(2)]
    for _ in range(2):      # the captures, then a warm group
        tr.optimize_scene_chain(hins)
    torch.cuda.synchronize()
    wins, results = {}, {}
    for detail in (False, True):
        tracing.enable(detail)
        before = _build.launch_counts()
        try:
            t0 = time.perf_counter()
            results[detail] = tr.optimize_scene_chain(hins)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        finally:
            tracing.enable(False)
        assert _build.launch_counts(since=before) == {
            "raster_loss_grad": 250, "raster_loss": 0,
            "preprocess_pack": 250, "preprocess_grad": 250,
            "compose_adam": 250, "issue_rate": 0}
        wins[detail] = win = tracing.window(t0, t1)
        assert win["units"] == 1 and not win["wrapped"]
        assert win["counters"]["graph_launches"] == 2 * 127
        assert win["by_label"]["graph_launches"] == {
            "prepare": 2, "step": 250, "collect": 2}
        assert win["by_label"]["k1_run_length"] == {str(R): 250}
        assert win["counters"]["host_syncs"] == win["counters"]["captures"] \
            == 0
        assert win["scenes"] == 2
        assert 0 < win["scene_device_s"] < t1 - t0
        assert 0 <= win["graph_gap_s"] < t1 - t0
    assert wins[False]["replays"] == {}
    replays = wins[True]["replays"]
    assert {k: v["n"] for k, v in replays.items()} == {
        "prepare": 2, "step": 250, "collect": 2}
    in_replays = sum(v["device_s"] for v in replays.values())
    assert in_replays <= wins[True]["scene_device_s"] * 1.001
    _assert_same(results[True], results[False])


@pytest.mark.cuda
def test_warm_calls_count_the_syncs_torch_detects(card):
    """A warm chain, batch and single scene make as many host syncs by
    the tracing module's counter as torch's sync detector reports: none
    with the cameras on the host; with them on the card, one copy of the
    camera centres for each scene's extent and one for the batch's."""
    import collections

    from skelsplat_tpu_torch import tracing
    from skelsplat_tpu_torch.core.cameras import stack_cameras

    init, gt, p2d, cams_np = synthetic_inputs(3, W, H)
    tr = _trainer(40)
    cameras = {}
    for device in ("cpu", "cuda"):
        cams = compat.camera_from_numpy(cams_np, device=device)
        cameras[device] = (cams, stack_cameras([cams] * 3))

    def calls(device):
        cams, cams_b = cameras[device]
        hins = [tr.host_inputs(init[s], p2d[s], cams, gt[s])
                for s in range(3)]
        tr.optimize_scene_chain(hins)
        tr.optimize_scene_batch(init, p2d, cams_b, gt)
        tr.optimize_scene(init[0], p2d[0], cams, gt[0])

    def syncs(device):
        torch.cuda.synchronize()
        before = collections.Counter(tracing.counters["host_syncs"])
        detected = _count_syncs(lambda: calls(device))
        by_site = tracing.counters["host_syncs"] - before
        torch.cuda.synchronize()
        return sum(by_site.values()), detected, dict(by_site)

    for _ in range(2):      # warm-up steps, then the captures
        calls("cpu")
        calls("cuda")
    assert syncs("cpu") == (0, 0, {})
    counted, detected, by_site = syncs("cuda")
    assert counted == detected > 0
    assert by_site == {"trainer.cameras_extent": 4,
                       "trainer.batch_extent": 1}


@pytest.fixture
def nccl_world_of_one(card, monkeypatch):
    """A process group of this process alone on NCCL (torchrun's
    environment for one rank), destroyed after the test."""
    from skelsplat_tpu_torch.parallel import launch

    for k, v in {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
                 "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(launch.free_port())}.items():
        monkeypatch.setenv(k, v)
    with launch.process_group("cuda") as dev:
        assert torch.distributed.get_backend() == "nccl"
        yield dev


@pytest.mark.cuda
def test_mesh_on_nccl_makes_no_host_sync(nccl_world_of_one):
    """The mesh's gather (an NCCL all_reduce of the summaries' bits) leaves
    them bitwise as they were and makes no host sync, however many run;
    multichip_optimize (general accumulation, 3 scenes) waits on the
    device as often for 2 macro steps as for 10."""
    from skelsplat_tpu_torch.core.cameras import stack_cameras
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings
    from skelsplat_tpu_torch.parallel.mesh import (_gather_blocks, make_mesh,
                                                   multichip_optimize)

    parts = [torch.randn(3, 4, device="cuda"),
             torch.randn(3, 4, 17, 3, device="cuda"),
             torch.tensor([-0.0, 0.0, 1.0], device="cuda").reshape(3, 1),
             torch.arange(3, device="cuda").reshape(3, 1)]
    out = _gather_blocks(parts, 1, 0, 1, None)
    for a, b in zip(out, parts):    # bits, so -0.0 must stay -0.0
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    torch.cuda.synchronize()
    syncs = {n: _count_syncs(lambda: [_gather_blocks(parts, 1, 0, 1, None)
                                      for _ in range(n)])
             for n in (2, 10)}
    assert syncs[2] == syncs[10], syncs

    init, gt, p2d, cams_np = synthetic_inputs(3, W, H)
    cams_b = stack_cameras([compat.camera_from_numpy(cams_np, device="cpu")]
                           * 3)
    mesh = make_mesh(1, 1, device_type="cuda")
    syncs = {}
    for iters in (8, 40):
        trainer = SceneTrainer(SkeletonModel("h36m", 17), OptConfig(iters),
                               TrainSettings(accumulation_steps=2), W, H,
                               renderer="cuda")
        multichip_optimize(mesh, trainer, init, p2d, cams_b, gt)  # warm-up
        torch.cuda.synchronize()
        syncs[iters] = _count_syncs(lambda: multichip_optimize(
            mesh, trainer, init, p2d, cams_b, gt))
    assert syncs[8] == syncs[40], syncs


@pytest.mark.cuda
def test_result_copy_returns_batch_k_while_batch_k1_runs(card):
    """The batched sweep's result copy of batch k (``engine/driver.py``'s
    ``_Fetch``: one non-blocking copy into pinned memory and an event
    behind it) returns batch k's values while ~1 s of batch k+1's work,
    enqueued after it on the same stream, still runs, and before batch
    k+1 changes the tensors; a blocking copy would wait for batch k+1."""
    import time

    from skelsplat_tpu_torch.engine.driver import _Fetch

    x = torch.arange(4096, dtype=torch.float32, device="cuda")
    stop = torch.full((3,), 8, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    fetch = _Fetch([x * 2, stop])
    torch.cuda._sleep(2_000_000_000)     # batch k+1: ~1 s of device time
    x.add_(1.0)
    stop.zero_()
    t0 = time.perf_counter()
    got = fetch.result()
    waited = time.perf_counter() - t0
    still_running = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert still_running, "batch k+1 ended before batch k's copy was read"
    assert waited < 0.5, waited
    np.testing.assert_array_equal(got[0], 2 * np.arange(4096, dtype=np.float32))
    np.testing.assert_array_equal(got[1], np.full(3, 8.0, np.float32))
    assert got[1].shape == (3,)


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
        before = _build.launch_counts()
        got = roofline.issue_rate(x, 128, chains, op)
        ref = roofline.issue_rate_plain(x, 128, chains, op)
        torch.cuda.synchronize()
        assert _build.launch_counts(since=before)["issue_rate"] == 1
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, ref), (op, chains)


_EVAL_PRECISION = """
import sys
import torch
import torch.nn.functional as F
import skelsplat_tpu_torch.eval
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
assert torch.get_float32_matmul_precision() == "highest"
loaded = [m for m in ("skelsplat_tpu_torch.ops.cuda_raster",
                      "skelsplat_tpu_torch.engine.trainer") if m in sys.modules]
assert not loaded, loaded
# a convolution of LPIPS's size on the card against float64: full f32
# rounds ~1e-7 of the scale, TF32's 10-bit mantissa ~1e-3
g = torch.Generator(device="cuda").manual_seed(0)
x = torch.rand((1, 64, 64, 64), device="cuda", generator=g)
w = torch.rand((64, 64, 3, 3), device="cuda", generator=g) - 0.5
y = F.conv2d(x, w, padding=1)
ref = F.conv2d(x.double().cpu(), w.double().cpu(), padding=1)
err = float((y.double().cpu() - ref).abs().max() / ref.abs().max())
assert err < 1e-5, err
print("full precision", err)
"""


@pytest.mark.cuda
def test_eval_entry_point_runs_full_precision_convolutions(card):
    """The eval path imports neither the kernel wrapper nor the trainer;
    its SSIM and LPIPS convolutions must still run in full f32."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _EVAL_PRECISION], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "full precision" in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("zero_error", [False, True])
def test_fusion_on_the_card_matches_the_cpu(card, zero_error):
    """tools/initial_guess.fuse_poses in float64 on the card against the
    CPU within 1e-9 mm, NaN where a camera's reprojection error is 0."""
    from skelsplat_tpu_torch.tools import make_synthetic_dataset as synth
    from skelsplat_tpu_torch.tools.initial_guess import fuse_poses

    rng = np.random.default_rng(3)
    cams = synth.make_rig()
    P = np.stack([K @ np.hstack([R, t.reshape(3, 1)]) for K, R, t in cams])
    gt = synth.make_motion(50)
    poses = gt[None] + rng.normal(0, 30.0, (4,) + gt.shape) \
        + rng.normal(0, 25.0, (4, 1, 1, 3))
    det = np.stack([np.stack([synth.project(K, R, t, f) for f in gt])
                    for K, R, t in cams]) + rng.normal(0, 2.0, (4, 50, 17, 2))
    if zero_error:   # integer affine cameras: camera 0 exact at (7, 3)
        P = np.zeros((4, 3, 4))
        P[:, 0, 0] = P[:, 1, 1] = np.arange(2.0, 6.0)
        P[:, 2, 3] = 1.0
        poses = np.round(poses)
        det[:, 7, 3] = P[:, :2, :3] @ poses[0, 7, 3]
    got = fuse_poses(poses, det, P, device="cuda")
    want = fuse_poses(poses, det, P, device="cpu")
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan) and nan.any() == zero_error
    assert np.abs(got[~nan] - want[~nan]).max() <= 1e-9
