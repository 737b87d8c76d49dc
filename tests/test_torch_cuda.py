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


def _count_syncs(fn):
    """The synchronizing CUDA calls ``fn`` makes, by torch's detector."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


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
    assert graph.nodes > 0 and graph.replays == 2 * tr.n_macro - 3
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
    out = [t.optimize_scene(init[0], p2d[0], cams, gt[0]) for t in trainers]
    assert not trainers[0].captures and not trainers[0].graphs
    assert trainers[1].captures and len(trainers[1].graphs) == 1
    graph = next(iter(trainers[1].graphs.values()))
    assert graph.nodes > 0 and graph.replays == trainers[1].n_macro - 3
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
    from skelsplat_tpu_torch.ops import cuda_raster as cr

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
    before = cr.launches["raster_loss_grad"]
    pg, hg = tr.optimize_scene_chain(hins)
    torch.cuda.synchronize()
    assert cr.launches["raster_loss_grad"] - before == 3 * tr.n_macro
    for s, (ps, hs) in enumerate(serial):
        for f in ("xyz", "log_scales", "quats", "opacity_logit"):
            assert torch.equal(getattr(pg, f)[s], getattr(ps, f))
        assert torch.equal(hg.losses[s], hs.losses)
        assert torch.equal(hg.error[s], hs.error)
        assert torch.equal(hg.stopped_at[s], hs.stopped_at)
    assert torch.equal(hg.hist8, h8)


@pytest.mark.cuda
def test_replays_make_no_host_sync_and_count_k1(card):
    """A replay waits on nothing: 20 steps of a captured graph make no
    synchronizing call, and each adds the graph's one K1 launch; a scene
    of 500 iterations counts 125 K1 launches, the first one (which warms
    up and captures its graph) too."""
    from skelsplat_tpu_torch.ops import cuda_raster as cr

    init, gt, p2d, cams_np = synthetic_inputs(2, W, H)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    tr = _trainer(500)
    for s in range(2):
        torch.cuda.synchronize()
        before = dict(cr.launches)
        tr.optimize_scene(init[s], p2d[s], cams, gt[s])
        torch.cuda.synchronize()
        assert cr.launches["raster_loss_grad"] - \
            before["raster_loss_grad"] == 125
        assert cr.launches["raster_loss"] == before["raster_loss"]
    graph = next(iter(tr.graphs.values()))
    assert graph.launches == {"raster_loss_grad": 1, "raster_loss": 0}
    graph.state.step.zero_()     # 20 more steps from the first
    torch.cuda.synchronize()
    before = cr.launches["raster_loss_grad"]
    assert _count_syncs(lambda: [graph.step() for _ in range(20)]) == 0
    torch.cuda.synchronize()
    assert cr.launches["raster_loss_grad"] == before + 20


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
        before = roofline.launches["issue_rate"]
        got = roofline.issue_rate(x, 128, chains, op)
        ref = roofline.issue_rate_plain(x, 128, chains, op)
        torch.cuda.synchronize()
        assert roofline.launches["issue_rate"] == before + 1
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
