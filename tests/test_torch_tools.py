"""The port's kernel-measurement tools against the JAX package's (CPU, tiny
sizes): K3's plain chain against the JAX chain, tile activity against
counts from the JAX preprocess and profiles, the trace summary's sweep
against the JAX one and on a torch-format trace, and the K1 probe's input
builder."""

import functools
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skelsplat_tpu.engine.trainer import init_params_jnp
from skelsplat_tpu.ops import heatmaps, rasterizer
from skelsplat_tpu.ops.pallas_raster import pallas_view_profiles
from skelsplat_tpu.tools import trace_summary as jts
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.ops import _build
from skelsplat_tpu_torch.ops import cuda_raster as cr
from skelsplat_tpu_torch.ops import heatmaps as thm
from skelsplat_tpu_torch.ops import rasterizer as trast
from skelsplat_tpu_torch.tools import kernel_probe, roofline
from skelsplat_tpu_torch.tools import trace_summary as tts
from tests.utils import project_np, synthetic_rig, synthetic_skeleton, take_cam

N_J = 17
W, H = 112, 96
NV = 3
# one exp step, 1e-7·exp(x) − 1e-7 for x in [0, 1): XLA's and torch's CPU
# exp 1 ulp apart (≤ 2.4e-7 below e) move the exact product by ≤ 2.4e-14,
# which rounds to at most one ulp of an output (≤ 2.9e-14 below 2.7e-7);
# 63 of these 1,024 outputs differ by one such ulp, and the tolerance is two
EXP_STEP_ATOL = 5.7e-14


def _jax_step(op):
    """One step of the TPU kernel's chain (skelsplat_tpu/tools/roofline.py:
    192-209), op by op."""
    def _mix(x):
        d = x - 0.5
        p = d * d
        q = p * 0.25 + x * 0.5
        m = (p <= 0.26) & (x >= 1e-3)
        return jnp.where(m, q, x)

    return {"fma": lambda x: x * 1.0000001 + 1e-9,
            "mul": lambda x: x * 1.0000001,
            "exp": lambda x: jnp.exp(x) * 1e-7 - 1e-7,
            "mix": _mix}[op]


def _jax_chain(x, k_steps, chains, op):
    """The TPU kernel's chain (skelsplat_tpu/tools/roofline.py:192-229),
    evaluated op by op without jit (under jit XLA contracts a·b+c into an
    FMA, which the kernel never does)."""
    step = _jax_step(op)
    unroll = 64
    xs = tuple(x * (1.0 + 1e-6 * c) for c in range(chains))
    for _ in range(k_steps // unroll):
        for _ in range(unroll // chains):
            xs = tuple(step(v) for v in xs)
    return functools.reduce(lambda a, b: a + b, xs)


@pytest.mark.parametrize("op", ["mul", "fma", "exp", "mix"])
def test_issue_step_matches_jax_step(op):
    """One step, where exp's value still shows (a chain of exp steps is
    exactly 0 from its third step on)."""
    x = np.random.default_rng(2).uniform(0, 1, 1024).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(_jax_step(op)(jnp.asarray(x)))
    got = roofline._steps("cpu")[op](torch.as_tensor(x)).numpy()
    if op == "exp":
        assert (ref > 0).all()
        np.testing.assert_allclose(got, ref, rtol=0, atol=EXP_STEP_ATOL)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("op", ["mul", "fma", "exp", "mix"])
def test_issue_rate_plain_matches_jax_chain(op, chains):
    """The whole chain, bitwise: for exp every output is exactly 0."""
    x = np.random.default_rng(0).uniform(0, 1, (8, 128)).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(_jax_chain(jnp.asarray(x), 64, chains, op))
    tx = torch.as_tensor(x.reshape(-1))
    before = _build.launch_counts()
    got = roofline.issue_rate(tx, 64, chains, op).numpy().reshape(8, 128)
    # the CPU runs the plain version
    assert _build.launch_counts(since=before) == dict.fromkeys(
        _build.KERNELS, 0)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)
    if op == "exp":
        assert not got.any()


@pytest.fixture(scope="module")
def scene():
    """The JAX package's rects and GT spans, and the port's pack, of one
    3-view 112×96 scene at its initial parameters. The heatmap spec is the
    port's (held against JAX in test_torch_heatmaps.py), handed to both."""
    cams, _, _ = synthetic_rig(n_views=NV, width=W, height=H)
    rng = np.random.default_rng(3)
    gt = synthetic_skeleton(N_J, rng=rng, spread=300.0)
    p2d = np.stack([project_np(gt, take_cam(cams, v))
                    for v in range(NV)]).astype(np.float32)
    init = gt + rng.normal(0, 50, gt.shape).astype(np.float32)
    params = init_params_jnp(jnp.asarray(init), "h36m", 3.0, 1.0)
    tp = compat.params_from_numpy(
        {f: np.asarray(getattr(params, f)) for f in
         ("xyz", "log_scales", "quats", "opacity_logit")}, device="cpu")
    tcams = compat.camera_from_numpy(jax.tree.map(np.asarray, cams),
                                     device="cpu")
    tspec = thm.heatmap_spec(tp.xyz, tp.covariance(), torch.as_tensor(p2d),
                             tcams, W, H)
    prof = cr.view_profiles(tspec, W, H)
    pp = trast.preprocess_gaussians(tp.xyz, tp.covariance(), tp.opacity,
                                    tcams, W, H)
    gd, aux, _, _ = cr.slot_pack(pp, prof)
    pack = torch.cat([gd, aux], dim=-1).contiguous()

    cov6 = params.covariance()
    jpp = jax.jit(jax.vmap(lambda cam: rasterizer.preprocess_gaussians(
        params.xyz, cov6, params.opacity, cam, W, H)))(
            jax.tree.map(jnp.asarray, cams))
    jspec = heatmaps.HeatmapSpec(*(jnp.asarray(t.numpy()) for t in tspec))
    spans = jax.jit(jax.vmap(lambda s: pallas_view_profiles(s, W, H)[3]))(
        jspec)
    return pack, prof.img, jpp, np.asarray(spans)


def _reference_activity(jpp, spans):
    """tile_activity's counts, pixel by pixel in numpy from the JAX
    preprocess rects and the JAX kernel profiles' GT spans."""
    ys = np.arange(H)[:, None]
    xs = np.arange(W)[None, :]
    ty, tx = ys // 16, xs // 16
    t_y = np.arange(-(-H // 16))[:, None]
    t_x = np.arange(-(-W // 16))[None, :]
    out = {k: [] for k in ("render_pairs", "gt_only_pairs", "active_tiles",
                           "flagged_pairs", "render_flagged")}
    for v in range(NV):
        r0, r1 = np.asarray(jpp.rect_min[v]), np.asarray(jpp.rect_max[v])
        opa = np.where(np.asarray(jpp.valid[v]),
                       np.asarray(jpp.opacity_eff[v]), 0)
        rend = gto = rflag = fl = 0
        any_flag = np.zeros((t_y.shape[0], t_x.shape[1]), bool)
        for j in range(N_J):
            gy0, gy1, gx0, gx1 = spans[v, j]
            in_rect = ((tx >= r0[j, 0]) & (tx < r1[j, 0])
                       & (ty >= r0[j, 1]) & (ty < r1[j, 1]) & (opa[j] > 0))
            in_gt = (ys >= gy0) & (ys < gy1) & (xs >= gx0) & (xs < gx1)
            rend += int(in_rect.sum())
            gto += int((in_gt & ~in_rect).sum())
            t_rect = ((t_x >= r0[j, 0]) & (t_x < r1[j, 0])
                      & (t_y >= r0[j, 1]) & (t_y < r1[j, 1]) & (opa[j] > 0))
            t_gt = ((gy0 < t_y * 16 + 16) & (gy1 > t_y * 16)
                    & (gx0 < t_x * 16 + 16) & (gx1 > t_x * 16))
            rflag += int(t_rect.sum())
            fl += int((t_rect | t_gt).sum())
            any_flag |= t_rect | t_gt
        for k, n in zip(out, (rend, gto, int(any_flag.sum()), fl, rflag)):
            out[k].append(n)
    return out


def test_tile_activity_matches_jax_rects_and_spans(scene):
    pack, img, jpp, spans = scene
    act = roofline.tile_activity(pack, img, (H, W))
    ref = _reference_activity(jpp, spans)
    assert act["tiles"] == 42
    for k, want in ref.items():
        assert act[k].tolist() == want, k
    assert min(ref["render_pairs"]) > 0 and min(ref["gt_only_pairs"]) > 0
    assert (act["flagged_per_slot"].sum(dim=1) == act["flagged_pairs"]).all()


def test_exclusive_times_matches_jax():
    mk = lambda name, ts, dur, tid: {"name": name, "ts": ts, "dur": dur,
                                     "pid": 1, "tid": tid}
    events = [mk("while", 0, 100, 7), mk("cond", 10, 30, 7),
              mk("fusion", 15, 10, 7), mk("cond", 50, 30, 7),
              mk("other", 0, 30, 8)]
    got = tts.exclusive_times([dict(e) for e in events])
    assert got == jts.exclusive_times([dict(e) for e in events])
    assert got[0]["while"] == 40 and sum(got[0].values()) == 130


def _torch_format_trace():
    """A small trace as torch.profiler's export_chrome_trace writes it: an
    aten op and a record_function range on the host thread with runtime
    launches inside, kernels and a memcpy on a stream lane linked by
    ``correlation``, the range's GPU mirror, and a flow event."""
    def x(cat, name, pid, tid, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
                "ts": ts, "dur": dur, "args": args}

    return {"schemaVersion": 1, "traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 9, "args": {"name": "python"}},
        {"ph": "M", "name": "thread_name", "pid": 9, "tid": 9,
         "args": {"name": "thread 9 (python)"}},
        x("cpu_op", "aten::mul", 9, 9, 100, 50, **{"External id": 1}),
        x("cuda_runtime", "cudaLaunchKernel", 9, 9, 110, 5, correlation=11),
        x("user_annotation", "skelsplat::raster_loss_grad", 9, 9, 200, 40),
        x("cuda_runtime", "cudaLaunchKernel", 9, 9, 205, 5, correlation=12),
        x("cuda_runtime", "cudaLaunchKernel", 9, 9, 215, 5, correlation=13),
        x("cuda_runtime", "cudaMemcpyAsync", 9, 9, 300, 5, correlation=14),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>", 0, 7,
          120, 3, correlation=11, stream=7),
        x("kernel", "skelsplat::live_tiles", 0, 7, 210, 6, correlation=12,
          stream=7),
        x("kernel", "void skelsplat::raster_loss_live<true, false, 24>", 0, 7,
          216, 80, correlation=13, stream=7),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 0, 7, 310, 2,
          correlation=14, stream=7),
        x("gpu_user_annotation", "skelsplat::raster_loss_grad", 0, 7, 210, 86),
        {"ph": "s", "id": 12, "pid": 9, "tid": 9, "ts": 205, "cat": "ac2g",
         "name": "ac2g"},
    ]}


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
def test_trace_summary_reads_torch_trace(tmp_path, capsys, suffix):
    path = tmp_path / f"trace{suffix}"
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(_torch_format_trace(), f)
    events = tts.load_trace_events(str(path))
    assert len(events) == 11
    assert events[0]["_proc"] == "python"
    assert events[0]["_thread"] == "thread 9 (python)"
    dev = tts.device_events(events)
    assert sorted(e["args"]["correlation"] for e in dev) == [11, 12, 13, 14]
    assert tts.launching_ops(events) == {
        11: "aten::mul", 12: "skelsplat::raster_loss_grad",
        13: "skelsplat::raster_loss_grad"}
    assert tts.range_launches(events, "skelsplat::raster_loss_grad") == \
        {12, 13}
    assert tts.range_launches(events, "aten::mul") == {11}
    per_k, counts, by_op, n_op = tts.main([str(tmp_path), "--by-op",
                                           "--macros", "2"])
    assert counts["void skelsplat::raster_loss_live<true, false, 24>"] == 1
    assert per_k["skelsplat::live_tiles"] == 6
    assert by_op == {"skelsplat::raster_loss_grad": 86, "aten::mul": 3,
                     "<unattributed>": 2}
    assert n_op["skelsplat::raster_loss_grad"] == 2
    printed = capsys.readouterr().out
    assert "4 device events, 0.091 ms exclusive" in printed
    assert "launching op" in printed and "us/macro" in printed


def test_launch_offsets():
    """Device start minus launch start per correlation id; a device event
    whose launch is not in the trace is left out, and a negative offset
    (the profiler's clock error) is kept as it is."""
    events = _torch_format_trace()["traceEvents"]
    events.append({"ph": "X", "cat": "kernel", "name": "orphan", "pid": 0,
                   "tid": 7, "ts": 400, "dur": 1,
                   "args": {"correlation": 99}})
    events.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "pid": 9, "tid": 9, "ts": 500,
                   "dur": 5, "args": {"correlation": 15}})
    events.append({"ph": "X", "cat": "kernel", "name": "early", "pid": 0,
                   "tid": 7, "ts": 497, "dur": 1,
                   "args": {"correlation": 15}})
    assert tts.launch_offsets(events) == {11: 10, 12: 5, 13: 1, 14: 10,
                                          15: -3}


def test_profiled_round_pads_both_edges(monkeypatch):
    """The calls run between two idle spans of PROFILE_EDGE_S, the second
    after the device has finished them, and the round ends in one step."""
    from skelsplat_tpu_torch.tools import timing

    log = []
    monkeypatch.setattr(timing.time, "sleep",
                        lambda s: log.append(("sleep", s)))
    monkeypatch.setattr(timing.torch.cuda, "synchronize",
                        lambda: log.append("sync"))

    class Prof:
        def step(self):
            log.append("step")

    timing.profiled_round(Prof(), lambda: log.append("call"), 3)
    edge = ("sleep", timing.PROFILE_EDGE_S)
    assert log == [edge, "call", "call", "call", "sync", edge, "step"]
    assert timing.PROFILE_EDGE_S > 0


@pytest.mark.parametrize("lost", [1, 5])
def test_cuda_ms_retakes_sessions_that_lost_records(monkeypatch, lost):
    """A profiler session in which a kernel kept under half its records is
    taken again; after PROFILE_ATTEMPTS such sessions cuda_ms raises."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from skelsplat_tpu_torch.tools import timing

    assert timing.PROFILE_ATTEMPTS == 5
    reps = 10
    # (name, device us per session, records) of each session's active round
    sessions = [[("list", 50.0, reps), ("tile", 140.0, 3)]] * lost + \
        [[("list", 60.0, reps), ("tile", 200.0, reps)]]
    taken = []

    class FakeProfile:
        def __init__(self, activities, schedule, on_trace_ready):
            self.ready, self.steps = on_trace_ready, 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            self.steps += 1
            if self.steps == 2:
                taken.append(sessions[len(taken)])
                self.ready(self)

        def key_averages(self):
            return [SimpleNamespace(key=k, device_time_total=t, count=n,
                                    device_type=DeviceType.CUDA)
                    for k, t, n in taken[-1]]

    class FakeEvent:
        def __init__(self, enable_timing):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 1.0

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(timing.time, "sleep", lambda s: None)
    per_kernel = {}
    if lost >= timing.PROFILE_ATTEMPTS:
        with pytest.raises(RuntimeError, match="in each of 5 sessions"):
            timing.cuda_ms(lambda: None, reps, each_kernel_once=True)
        assert len(taken) == timing.PROFILE_ATTEMPTS
        return
    ms, stream_ms = timing.cuda_ms(lambda: None, reps, each_kernel_once=True,
                                   per_kernel=per_kernel)
    assert len(taken) == lost + 1
    assert ms == pytest.approx((60.0 + 200.0) / reps / 1e3)
    assert per_kernel == pytest.approx({"list": 0.006, "tile": 0.02})
    assert stream_ms == pytest.approx(1.0 / reps)


@pytest.fixture(scope="module")
def probe_small():
    return kernel_probe.probe_inputs(W, H, n_views=2, device="cpu")


def test_dead_inputs_do_no_work(probe_small):
    pack, p1s, p2s, img = probe_small
    pk, p1 = kernel_probe.keep_slots(pack, p1s, 0)
    act = roofline.tile_activity(pk, img, (H, W))
    assert act["active_tiles"].tolist() == [0, 0]
    assert int(act["render_pairs"].sum()) == int(act["gt_only_pairs"].sum()) == 0
    S, C, dg = cr.raster_loss_grad(pk, p1, p2s, img, False)
    assert S.tolist() == [0.0, 0.0] and C.tolist() == [0, 0]
    assert float(dg.abs().max()) == 0.0
    # the builder's live inputs do work in every view
    live = roofline.tile_activity(pack, img, (H, W))
    assert (live["active_tiles"] > 0).all()


@pytest.mark.parametrize("n", [1, 5])
def test_live_slots_flag_only_the_first_slots(probe_small, n):
    pack, p1s, p2s, img = probe_small
    full = roofline.tile_activity(pack, img, (H, W))["flagged_per_slot"]
    pk, p1 = kernel_probe.keep_slots(pack, p1s, n)
    part = roofline.tile_activity(pk, img, (H, W))["flagged_per_slot"]
    assert (part[:, n:] == 0).all()
    assert torch.equal(part[:, :n], full[:, :n])
    assert (full[:, n:] > 0).any()
    # the inputs are copies
    assert not torch.equal(pk, pack)


def test_kernel_bound_published_and_measured(probe_small):
    pack, p1s, p2s, img = probe_small
    act = roofline.tile_activity(pack, img, (H, W))
    b = roofline.kernel_bound(pack, p1s, p2s, img, True)
    assert b["measured"] is None
    rend, gto = int(act["render_pairs"].sum()), int(act["gt_only_pairs"].sum())
    assert b["ops"] == rend * (39 + 33) + gto * 7 and b["expf"] == rend
    assert b["published"] == ((b["ops"] + b["expf"]) / 67e12 * 1e3,
                              "operations")
    rates = {"mul": 3e13, "fma": 3e13, "exp": 2e12, "mix": 3.2e13}
    m = roofline.kernel_bound(pack, p1s, p2s, img, True, rates, act)
    assert m["exp_weight"] == pytest.approx(14.0)
    assert m["measured"][0] == pytest.approx(
        (b["ops"] + 14.0 * b["expf"]) / 3.2e13 * 1e3)
    # K2 is pass 1 alone
    k2 = roofline.kernel_bound(pack, p1s, p2s, img, False, activity=act)
    assert k2["ops"] == rend * 39 + gto * 7 and k2["expf"] == rend


def test_wrappers_reject_bad_inputs(probe_small):
    x = torch.rand(256)
    with pytest.raises(TypeError):
        roofline.issue_rate(x.double(), 64, 1, "mul")
    with pytest.raises(ValueError):
        roofline.issue_rate(x.reshape(16, 16), 64, 1, "mul")
    with pytest.raises(ValueError):
        roofline.issue_rate(x[::2], 64, 1, "mul")
    with pytest.raises(ValueError):
        roofline.issue_rate(x, 100, 1, "mul")
    with pytest.raises(ValueError):
        roofline.issue_rate(x, 64, 3, "mul")
    with pytest.raises(ValueError):
        roofline.issue_rate(x, 64, 1, "div")
    with pytest.raises(ValueError, match="unsupported device"):
        roofline.issue_rate(x.to("meta"), 64, 1, "mul")
    pack, _, _, img = probe_small
    with pytest.raises(ValueError):
        roofline.tile_activity(pack[:, :, :8], img)
    with pytest.raises(ValueError):
        roofline.tile_activity(pack, img[:1])
    with pytest.raises(TypeError):
        roofline.tile_activity(pack.double(), img)
    with pytest.raises(RuntimeError, match="GPU"):
        kernel_probe.time_k1(*probe_small)


def test_roofline_main_counts_on_cpu_and_probe_needs_gpu(capsys):
    out = roofline.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "pass2" in printed and "render pairs" in printed
    assert "no issue rate" in printed
    assert out["rates"] is None and out["bound"]["measured"] is None
    assert out["activity"]["tiles"] == 63 * 63
    assert (out["activity"]["active_tiles"] > 0).all()
    with pytest.raises(RuntimeError, match="GPU"):
        roofline.main(["--probe", "--device", "cpu"])


def test_slot_counts_match_a_hand_count():
    """The histograms of flagged and render slots over a call's live list
    entries, on a hand-built pack of 2 views × 3 slots over 2 × 2 tiles."""
    from skelsplat_tpu_torch.tools import k1_variants as kv

    pack = torch.zeros(2, 3, cr.PACK)

    def slot(v, i, opa=0.0, rect=(0, 0, 0, 0), gt=(0, 0, 0, 0)):
        pack[v, i, cr.IDX_OPA] = opa
        pack[v, i, cr.IDX_RX0:cr.IDX_RY1 + 1] = torch.tensor(rect)
        pack[v, i, cr.IDX_GY0:cr.IDX_GX1 + 1] = torch.tensor(gt)

    # view 0: slot 0 renders on all 4 tiles, slot 1 on tile 1 with its GT
    # on tile 0, slot 2 has its GT on tile 3 alone; view 1: slot 0's GT on
    # tile 1 alone
    slot(0, 0, 1.0, rect=(0, 0, 2, 2))
    slot(0, 1, 1.0, rect=(1, 0, 2, 1), gt=(0, 16, 0, 16))
    slot(0, 2, gt=(16, 32, 16, 32))
    slot(1, 0, gt=(0, 8, 20, 24))
    out = kv.slot_counts(pack, 32, 32)
    _, _, live_n = cr.live_tiles_plain(pack, 32, 32)
    assert live_n.tolist() == [4, 1]
    # flagged, by tile: v0 {0, 1}, {0, 1}, {0}, {0, 2}; v1 {0}
    assert out["flagged"] == [0, 2, 3, 0]
    # render, by tile: v0 {0}, {0, 1}, {0}, {0}; v1 none
    assert out["render"] == [1, 3, 1, 0]
    assert out["entries"] == sum(out["flagged"]) == sum(out["render"]) \
        == int(live_n.sum())
    assert out["no_render_share"] == pytest.approx(1 / 5)


def test_k1_variants_cells_carry_their_models_scale():
    """Occlusion-Person's K1 call is made with its model: the extremity
    joints at 1.25 × the log-scale widen their splats and GT blurs, so its
    live list has more entries than the same frame at modifier 1.0, and
    the slots an entry flags are counted over the 15 slots."""
    from skelsplat_tpu_torch.tools import k1_variants as kv

    cell = next(c for c in kv.CELLS if c.name == "op.chain32")
    assert (cell.dataset, cell.modifier, cell.joints) == (
        "occlusion-person", 1.25, 15)
    counts = {}
    for c in (cell, cell._replace(modifier=1.0)):
        pack, p1s, p2s, img = kv.cell_inputs(c, device="cpu")
        assert pack.shape == (4, 15, cr.PACK)
        counts[c.modifier] = kv.slot_counts(pack, c.height, c.width)
    assert counts[1.25]["entries"] > counts[1.0]["entries"]
    assert len(counts[1.25]["flagged"]) == 16
