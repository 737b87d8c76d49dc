#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU (sm_90a, e.g. an H100).

    python3 chip_smoke.py [--profile]

Phases, each failing the script (nonzero exit) on any error:

1. build   — nvcc builds the kernels from skelsplat_tpu_torch/csrc;
             prints the build time, ptxas' register report and the card's
             name and power limit.
2. kernels — K1 (raster_loss_grad) and K2 (raster_loss) against their plain
             PyTorch versions on the card at H36M size (4 views, 1002×1000
             grid, 17 joints): a mixed 1000/1002-wide rig with l2_gaussian,
             the same with l1_gaussian, and a rig with one splat behind a
             camera. C must match exactly; S and each gradient component of
             dg within the stated tolerance; two K1 runs must be bitwise
             equal. Times each kernel, its plain version and its bound.
3. path    — one synthetic H36M frame (4 views at 1002×1000, 17 joints,
             500 iterations = 125 macro steps, l2_gaussian + limb
             consistency) through SceneTrainer.optimize_scene(renderer=
             "cuda"). The launch counts are read around optimize_scene
             alone: exactly 125 K1 launches and no K2 launch (the path
             always takes gradients, as the JAX path does). Asserts finite
             xyz, falling MPJPE, and a falling no-grad loss (K2, scored
             outside the counted window); then times TIMED_FRAMES more frames
             (s/frame, through a host copy of xyz).
4. agree   — 12 iterations of renderer="cuda" against renderer="fused"
             (the autograd row-chunk stream) on the card: xyz within 1e-4.

The line before the last is {"kernels": [...], "off_path_kernels": [...]}:
"kernels" lists the kernels the path launched (K1), "off_path_kernels"
those the port holds that the path does not launch (K2, launches 0); the
last line is {"ok": true, "device": {...}}. ``--profile`` adds a torch.profiler pass
over one frame (device time by kernel, device busy share).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

W, H, N_JOINTS, N_VIEWS = 1002, 1000, 17, 4
MIXED_WIDTHS = (1002, 1000, 1002, 1000)
ITERATIONS = 500
TIMED_FRAMES = 3  # timed frames after the checked one
# the kernels optimize_scene launches (K1); the port's other kernel, K2
# (raster_loss), is the no-grad loss, which the path never evaluates
PATH_KERNELS = ("raster_loss_grad",)
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and
# f32 non-tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations per (pixel, slot) pair, read off csrc/raster_loss.cu:
# pass 1 with the slot's rect on the tile (offsets, power, exp, clamp,
# gates, T update, GT, error, sums) and without it (GT-only terms); pass 2
# (GT, ghat, dalpha, exp, six gradient terms, suffix)
OPS_PASS1_REND, OPS_PASS1_GT, OPS_PASS2 = 32, 6, 44
# dg tolerance relative to the largest |dg| of the same view and gradient
# component (px, py, a, b, c or opa) over the slots: both sides sum ~1e5
# per-pixel f32 terms, the kernel by warp/tile trees and the plain version
# by torch's reductions, so only the summation order differs; that order
# moves the sums by ~2e-7 of this scale on an H100, 50x inside the bound
DG_RTOL = 1e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> tuple[float, float]:
    """(device ms, stream ms) per call of ``fn``: the summed duration of the
    kernels it launches (torch.profiler), and CUDA-event time over ``reps``
    back-to-back calls, which includes any host time the device waits for
    (the wrapper's own Python overhead when a kernel is shorter)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    stream_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    assert dev_us > 0, "the profiler recorded no kernel"
    return dev_us / reps / 1e3, stream_ms


def kernel_inputs(widths, behind_camera: bool, seed: int):
    """Depth-sorted packs of one synthetic frame at a perturbed pose."""
    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch.core.gaussians import init_params
    from skelsplat_tpu_torch.ops import cuda_raster, heatmaps, rasterizer
    from skelsplat_tpu_torch.synthetic import synthetic_inputs

    init, _, p2d, cams_np = synthetic_inputs(1, W, H, n_views=N_VIEWS,
                                             n_joints=N_JOINTS, seed=seed,
                                             widths=widths)
    pose = init[0].copy()
    if behind_camera:
        c = cams_np["cam_center"][0].astype(np.float64)
        away = c - pose.mean(axis=0)
        pose[4] = c + 300.0 * away / np.linalg.norm(away)
    cams = compat.camera_from_numpy(cams_np, device="cuda")
    params = init_params(pose, "h36m", 3.0, 1.0, device="cuda")
    spec = heatmaps.heatmap_spec(params.xyz, params.covariance(),
                                 torch.as_tensor(p2d[0], device="cuda"),
                                 cams, W, H)
    rng = np.random.default_rng(seed + 1)
    params = type(params)(
        params.xyz,
        params.log_scales + torch.as_tensor(
            rng.normal(0, 0.3, (N_JOINTS, 3)), dtype=torch.float32,
            device="cuda"),
        params.quats + torch.as_tensor(
            rng.normal(0, 0.2, (N_JOINTS, 4)), dtype=torch.float32,
            device="cuda"),
        params.opacity_logit)
    prof = cuda_raster.view_profiles(spec, W, H)
    pp = rasterizer.preprocess_gaussians(params.xyz, params.covariance(),
                                         params.opacity, cams, W, H)
    if behind_camera:
        assert not bool(pp.valid[0, 4]), "joint 4 should be behind camera 0"
    gd, aux, p1s, p2s = cuda_raster.slot_pack(pp, prof)
    pack = torch.cat([gd, aux], dim=-1).contiguous()
    return pack, p1s, p2s, prof.img


def pair_counts(pack, img):
    """(render pairs, GT-only pairs): (pixel, slot) pairs inside each view's
    image whose tile the slot's rect covers with nonzero opacity, and those
    outside it that lie in the slot's GT support — the work this input
    needs, as the kernel's tile flags define it."""
    from skelsplat_tpu_torch.ops import cuda_raster as cr

    ys = torch.arange(H, device=pack.device, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=pack.device, dtype=torch.float32)
    ty, tx = torch.floor(ys / 16), torch.floor(xs / 16)
    rend = gt_only = 0
    for v in range(pack.shape[0]):
        in_img = (ys < img[v, 1]) & (xs < img[v, 0])
        for i in range(pack.shape[1]):
            s = pack[v, i]
            r = (in_img & (s[cr.IDX_OPA] > 0)
                 & (tx >= s[cr.IDX_RX0]) & (tx < s[cr.IDX_RX1])
                 & (ty >= s[cr.IDX_RY0]) & (ty < s[cr.IDX_RY1]))
            g = (in_img & ~r & (ys >= s[cr.IDX_GY0]) & (ys < s[cr.IDX_GY1])
                 & (xs >= s[cr.IDX_GX0]) & (xs < s[cr.IDX_GX1]))
            rend += int(r.sum())
            gt_only += int(g.sum())
    return rend, gt_only


def bound_ms(pack, p1s, p2s, img, with_grad: bool):
    """The least time for the function on these inputs: the larger of its
    bytes (inputs read once, outputs written once) over HBM bandwidth and
    its f32 operations over the f32 peak. Returns (ms, "bytes"|"operations")."""
    V, N, _ = pack.shape
    out_floats = 2 * V + (V * N * 6 if with_grad else 0)
    n_bytes = 4 * (pack.numel() + p1s.numel() + p2s.numel() + img.numel()
                   + out_floats)
    rend, gt_only = pair_counts(pack, img)
    ops = rend * (OPS_PASS1_REND + (OPS_PASS2 if with_grad else 0)) \
        + gt_only * OPS_PASS1_GT
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def dg_rel_err(dg, dgp):
    """(6,) worst |dg − dgp| per gradient component, each relative to the
    largest |dgp| of its view and component over the slots."""
    scale = dgp.abs().amax(dim=1, keepdim=True)
    assert bool((scale > 0).all()), "a view has an all-zero gradient component"
    return ((dg - dgp).abs() / scale).amax(dim=(0, 1))


def phase_kernels():
    from skelsplat_tpu_torch.ops import cuda_raster as cr

    cases = [("mixed rig, l2_gaussian", MIXED_WIDTHS, False, False, 0),
             ("mixed rig, l1_gaussian", MIXED_WIDTHS, False, True, 0),
             ("splat behind camera 0, l2_gaussian", None, True, False, 5)]
    err = {"raster_loss_grad": 0.0, "raster_loss": 0.0}
    for name, widths, behind, l1, seed in cases:
        pack, p1s, p2s, img = kernel_inputs(widths, behind, seed)
        before = dict(cr.launches)
        S, C, dg = cr.raster_loss_grad(pack, p1s, p2s, img, l1)
        S_b, C_b, dg_b = cr.raster_loss_grad(pack, p1s, p2s, img, l1)
        S2, C2 = cr.raster_loss(pack, p1s, p2s, img, l1)
        torch.cuda.synchronize()
        assert cr.launches["raster_loss_grad"] == before["raster_loss_grad"] + 2
        assert cr.launches["raster_loss"] == before["raster_loss"] + 1
        Sp, Cp, dgp = cr.raster_loss_grad_plain(pack, p1s, p2s, img, l1)
        S2p, C2p = cr.raster_loss_plain(pack, p1s, p2s, img, l1)
        torch.cuda.synchronize()
        assert torch.equal(S, S_b) and torch.equal(C, C_b) \
            and torch.equal(dg, dg_b), f"{name}: two K1 runs differ"
        assert torch.equal(C, Cp) and torch.equal(C2, C2p), \
            f"{name}: C {C.tolist()} vs plain {Cp.tolist()}"
        assert bool((C > 0).all()), f"{name}: empty mask"
        assert torch.isfinite(dg).all() and torch.isfinite(S).all(), name
        torch.testing.assert_close(S, Sp, rtol=1e-5, atol=0)
        torch.testing.assert_close(S2, S2p, rtol=1e-5, atol=0)
        rel = dg_rel_err(dg, dgp)
        assert float(rel.max()) <= DG_RTOL, \
            f"{name}: dg off by {rel.tolist()} of its scale per component"
        if behind:
            assert float(dg[0, -1].abs().max()) == 0.0, \
                "the culled splat sorts last in view 0 and gets no gradient"
        err["raster_loss_grad"] = max(err["raster_loss_grad"],
                                      float((dg - dgp).abs().max()),
                                      float((S - Sp).abs().max()))
        err["raster_loss"] = max(err["raster_loss"],
                                 float((S2 - S2p).abs().max()))
        print(f"  {name}: S {S.tolist()} C {C.tolist()} "
              f"|dS| {float((S - Sp).abs().max()):.3g} "
              f"dg rel err per component (px py a b c opa) "
              f"{[float(f'{r:.3g}') for r in rel.tolist()]}", flush=True)
    # times at the main path's shapes (uniform 1002x1000 rig, l2)
    pack, p1s, p2s, img = kernel_inputs(None, False, 0)
    rows = []
    for name, line, grad, fn, plain in (
            ("raster_loss_grad", 466, True, cr.raster_loss_grad,
             cr.raster_loss_grad_plain),
            ("raster_loss", 320, False, cr.raster_loss, cr.raster_loss_plain)):
        ms, stream_ms = cuda_ms(lambda: fn(pack, p1s, p2s, img, False),
                                reps=200)
        plain_ms, plain_stream_ms = cuda_ms(
            lambda: plain(pack, p1s, p2s, img, False), reps=3, warmup=1)
        b_ms, b_by = bound_ms(pack, p1s, p2s, img, grad)
        rows.append({"name": name, "route": "cuda",
                     "source": "skelsplat_tpu_torch/csrc/raster_loss.cu",
                     "replaces": f"skelsplat_tpu/ops/pallas_raster.py:{line}",
                     "launches": None, "max_abs_err": err[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        print(f"  {name}: {ms:.4f} ms/call device time ({stream_ms:.4f} ms "
              f"back to back); plain {plain_ms:.2f} ms device time "
              f"({plain_stream_ms:.2f} back to back); bound {b_ms:.6f} ms by "
              f"{b_by}", flush=True)
    return rows


def make_trainer(iterations: int, renderer: str):
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings

    return SceneTrainer(SkeletonModel("h36m", N_JOINTS, scaling=3.0,
                                      scaling_modifier=1.0),
                        OptConfig(iterations=iterations), TrainSettings(),
                        W, H, renderer=renderer, device="cuda")


def frame_loss(pose, p2d, cams, xyz=None):
    """(V,) no-grad kernel loss (K2) of a frame at its initial parameters,
    or with ``xyz`` in place of the initial means."""
    from skelsplat_tpu_torch.core.gaussians import init_params
    from skelsplat_tpu_torch.ops import cuda_raster, heatmaps

    params = init_params(pose, "h36m", 3.0, 1.0, device="cuda")
    spec = heatmaps.heatmap_spec(params.xyz, params.covariance(),
                                 torch.as_tensor(p2d, device="cuda"), cams,
                                 W, H)
    prof = cuda_raster.view_profiles(spec, W, H)
    if xyz is not None:
        params = type(params)(xyz, params.log_scales, params.quats,
                              params.opacity_logit)
    with torch.no_grad():
        return cuda_raster.fused_view_loss_cuda(params, cams, prof, W, H)


def phase_path(profile: bool):
    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch.ops import cuda_raster as cr
    from skelsplat_tpu_torch.synthetic import mpjpe, synthetic_inputs

    init, gt, p2d, cams_np = synthetic_inputs(1 + TIMED_FRAMES, W, H,
                                              n_views=N_VIEWS,
                                              n_joints=N_JOINTS, seed=0)
    cams = compat.camera_from_numpy(cams_np, device="cuda")
    trainer = make_trainer(ITERATIONS, "cuda")
    loss0 = frame_loss(init[0], p2d[0], cams)
    torch.cuda.synchronize()

    for k in cr.launches:
        cr.launches[k] = 0
    t0 = time.perf_counter()
    params, hist = trainer.optimize_scene(init[0], p2d[0], cams, gt[0],
                                          lean=True)
    xyz = params.xyz.cpu().numpy()
    first_s = time.perf_counter() - t0
    counts = dict(cr.launches)
    loss1 = frame_loss(init[0], p2d[0], cams, xyz=params.xyz)

    assert xyz.shape == (N_JOINTS, 3) and np.isfinite(xyz).all()
    e0, e1 = mpjpe(init[0], gt[0]), mpjpe(xyz, gt[0])
    l0, l1 = loss0.cpu().numpy(), loss1.cpu().numpy()
    print(f"  frame 0: MPJPE {e0:.3f} -> {e1:.3f} mm, loss {l0.tolist()} -> "
          f"{l1.tolist()}, launches {counts}, {first_s:.3f} s with warm-up",
          flush=True)
    assert e1 < e0, "MPJPE did not fall"
    assert (l1 < l0).all(), "the per-view loss did not fall"
    assert counts == {"raster_loss_grad": ITERATIONS // 4,
                      "raster_loss": 0}, counts
    assert int(hist.stopped_at) == 0

    times, errs = [], []
    for s in range(1, 1 + TIMED_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, _ = trainer.optimize_scene(init[s], p2d[s], cams, gt[s],
                                           lean=True)
        xyz = params.xyz.cpu().numpy()
        times.append(time.perf_counter() - t0)
        assert np.isfinite(xyz).all()
        errs.append((mpjpe(init[s], gt[s]), mpjpe(xyz, gt[s])))
    print(f"  timed frames: {[round(t, 6) for t in times]} s; MPJPE "
          f"{[(round(a, 3), round(b, 3)) for a, b in errs]} mm", flush=True)
    assert all(b < a for a, b in errs)
    s_per_frame = float(np.median(times))

    if profile:
        profile_frame(trainer, init[1], p2d[1], cams, gt[1], s_per_frame)
    return counts, s_per_frame, (e0, e1)


def profile_frame(trainer, init, p2d, cams, gt, s_per_frame: float):
    """Device time by kernel and the device busy share over one frame:
    the sum of kernel durations over the profiled wall time, and over the
    unprofiled s/frame (the profiler slows the host, not the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, _ = trainer.optimize_scene(init, p2d, cams, gt, lean=True)
        params.xyz.cpu()
        wall = time.perf_counter() - t0
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    assert rows, "the profiler recorded no kernel"
    busy = sum(r[0] for r in rows) / 1e6
    print(f"  profile: {sum(r[1] for r in rows)} kernels, device busy "
          f"{busy:.4f} s = {busy / wall:.4f} of the profiled wall "
          f"{wall:.4f} s, {busy / s_per_frame:.4f} of the unprofiled "
          f"{s_per_frame:.4f} s/frame", flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"    {dev_us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")


def phase_agree():
    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch.synthetic import synthetic_inputs

    init, gt, p2d, cams_np = synthetic_inputs(1, W, H, n_views=N_VIEWS,
                                              n_joints=N_JOINTS, seed=0)
    cams = compat.camera_from_numpy(cams_np, device="cuda")
    out = {}
    for r in ("cuda", "fused"):
        params, hist = make_trainer(12, r).optimize_scene(
            init[0], p2d[0], cams, gt[0])
        out[r] = (params.xyz.cpu().numpy(), hist.losses.cpu().numpy())
    dx = float(np.abs(out["cuda"][0] - out["fused"][0]).max())
    dl = float(np.abs(out["cuda"][1] / out["fused"][1] - 1).max())
    print(f"  12 iterations: max |Δxyz| {dx:.3g} mm, max loss rel diff "
          f"{dl:.3g}", flush=True)
    assert dx < 1e-4, dx
    assert dl < 1e-5, dl


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one frame with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1

    from skelsplat_tpu_torch.ops import _build

    print("[1/4] build", flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"  {lib_path.name}: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'reused'})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"  card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    print("[2/4] kernels against their plain versions", flush=True)
    rows = phase_kernels()

    print("[3/4] path: one H36M frame through SceneTrainer.optimize_scene",
          flush=True)
    counts, s_per_frame, (e0, e1) = phase_path(args.profile)
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(f"  {s_per_frame:.6f} s/frame (median of {TIMED_FRAMES}; "
          f"{ITERATIONS} iterations, 4 views at {W}x{H}) on {card}",
          flush=True)

    print("[4/4] renderer agreement: cuda vs fused", flush=True)
    phase_agree()

    print(card)
    print(json.dumps({
        "kernels": [r for r in rows if r["name"] in PATH_KERNELS],
        "off_path_kernels": [r for r in rows
                             if r["name"] not in PATH_KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
