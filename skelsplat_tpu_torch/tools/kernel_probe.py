"""On-card probe of the raster-loss kernel K1 alone
(counterpart of ``skelsplat_tpu/tools/kernel_probe.py``).

Times K1 (``ops/cuda_raster.py::raster_loss_grad``) at the main path's
shapes, 4 views of 1002×1000, 17 slots, l2, on a depth-sorted pack built
through the port's own preprocess and ``slot_pack`` at the initial
parameters of a synthetic H36M frame, and splits its time into fixed cost
and work:

* ``--dead`` kills every slot in the same inputs (zero opacity, zero GT
  span, zero GT row profile), so no tile is live: the list kernel
  (``live_tiles`` in csrc/raster_loss.cu) finds none and zeroes every
  view's outputs, and every block of the persistent tile kernel exits at
  its first list lookup. That is the launch floor.
* ``--live-slots n1 n2 ...`` keeps the first n slots of each view live and
  kills the rest, then fits time against flagged (tile, slot) pairs with
  ``np.polyfit``: the slope is the cost of one flagged pair, the
  intercept the fixed cost of a launch. (The TPU probe swept slot widths,
  which a tile kernel does not have.)

It also prints the tile kernel's registers and resident blocks per SM and
the live launch's device time split by kernel. It times a kernel, so it
needs the GPU and raises without one. The input builder ``probe_inputs``
also runs on the CPU.

``step_inputs`` builds a macro step's inputs for kernels A and B of
``ops/cuda_preprocess.py``, and ``autograd_step`` the same step's losses
and gradients through autograd, the reference both are held to (on the
CPU too).

Usage:
    python -m skelsplat_tpu_torch.tools.kernel_probe [--dead]
        [--live-slots 0 1 2 4 8 12 17]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.ops import cuda_raster as cr
from skelsplat_tpu_torch.tools.roofline import tile_activity

W, H, N_JOINTS, N_VIEWS = 1002, 1000, 17, 4


def probe_inputs(width: int = W, height: int = H, n_joints: int = N_JOINTS,
                 n_views: int = N_VIEWS, seed: int = 0, device="cuda",
                 widths=None, behind_camera: bool = False,
                 perturb: bool = False, ring: float = 4200.0,
                 one_point: bool = False):
    """(pack (V,N,16), p1 (V,N,H), p2 (V,N,W), img (V,2)) of frame 0 of the
    synthetic scenes from ``seed`` at its initial parameters, depth-sorted
    and packed as ``fused_view_loss_cuda`` packs them for K1. ``widths``
    gives each view its true image width (``width`` is the grid's);
    ``behind_camera`` moves joint 4 behind camera 0, which culls it there;
    ``perturb`` draws anisotropic scales and rotations from ``seed`` + 1;
    ``ring`` is the rig's camera distance (``synthetic_inputs``);
    ``one_point`` puts every joint at the pose's mean (the GT stays the
    drawn pose's), so the splats overlap and some tiles flag every slot."""
    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch.core.gaussians import init_params
    from skelsplat_tpu_torch.ops import heatmaps, rasterizer
    from skelsplat_tpu_torch.synthetic import synthetic_inputs

    dev = resolve_device(device)
    init, _, p2d, cams_np = synthetic_inputs(1, width, height,
                                             n_views=n_views,
                                             n_joints=n_joints, seed=seed,
                                             widths=widths, ring=ring)
    pose = init[0].copy()
    if one_point:
        pose[:] = pose.mean(axis=0)
    if behind_camera:
        c = cams_np["cam_center"][0].astype(np.float64)
        away = c - pose.mean(axis=0)
        pose[4] = c + 300.0 * away / np.linalg.norm(away)
    cams = compat.camera_from_numpy(cams_np, device=dev)
    params = init_params(pose, "h36m", 3.0, 1.0, device=dev)
    spec = heatmaps.heatmap_spec(params.xyz, params.covariance(),
                                 torch.as_tensor(p2d[0], device=dev), cams,
                                 width, height)
    if perturb:
        rng = np.random.default_rng(seed + 1)

        def noise(sigma, shape):
            return torch.as_tensor(rng.normal(0, sigma, shape),
                                   dtype=torch.float32, device=dev)

        params = type(params)(params.xyz,
                              params.log_scales + noise(0.3, (n_joints, 3)),
                              params.quats + noise(0.2, (n_joints, 4)),
                              params.opacity_logit)
    prof = cr.view_profiles(spec, width, height)
    with torch.no_grad():
        pp = rasterizer.preprocess_gaussians(params.xyz, params.covariance(),
                                             params.opacity, cams, width,
                                             height)
        if behind_camera and bool(pp.valid[0, 4]):
            raise RuntimeError("joint 4 is not behind camera 0")
        gd, aux, p1s, p2s = cr.slot_pack(pp, prof)
        pack = torch.cat([gd, aux], dim=-1).contiguous()
    return pack, p1s, p2s, prof.img


def probe_inputs_batch(n_scenes: int, width: int = W, height: int = H,
                       device="cuda", widths=None, perturb: bool = False):
    """K1's inputs for a macro step of a batch of ``n_scenes`` scenes, as
    the batched trainer gives them: every scene's views one scene after
    another (V = n_scenes · 4). Scene s is ``probe_inputs`` of seed s seen
    by its own rig, at 3800 + 100·s mm."""
    parts = [probe_inputs(width, height, seed=s, device=device,
                          widths=widths, perturb=perturb,
                          ring=3800.0 + 100.0 * s) for s in range(n_scenes)]
    return tuple(torch.cat(xs).contiguous() for xs in zip(*parts))


def step_inputs(scene_type: str = "h36m", n_scenes: int = 1,
                width: int = W, height: int = H, seed: int = 0,
                device="cuda", behind_camera: bool = False,
                beyond_clamp: bool = False, infinite_logit: bool = False):
    """(params (S,N,·), cameras (S·4 views), prof, A = 4): the inputs of a
    macro step that visits every view of ``n_scenes`` synthetic scenes,
    as ``cuda_preprocess.view_forward`` takes them. Scene s is frame 0
    of seed ``seed`` + s, its GT profiles from its initial Gaussians (the
    trainer's prepare); its parameters are then moved off their start by a
    numpy generator (xyz ±15 mm, log-scales ±0.3, quaternions ±0.3,
    opacity logits 1 ± 1), so that every term of the gradient is live.
    ``behind_camera`` puts scene 0's joint 4 behind camera 0 (culled
    there); ``beyond_clamp`` puts its joint 7 in front of camera 1 at 1.35
    tan(fov/2) off axis, past the EWA clamp, with scales of 665, 245
    and 403 mm that reach into the image; ``infinite_logit`` sets every
    opacity logit to +inf (the reference's initial value)."""
    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch.core.cameras import FIELDS, Camera
    from skelsplat_tpu_torch.core.gaussians import (N_JOINTS, PARAM_FIELDS,
                                                    GaussianParams,
                                                    init_params)
    from skelsplat_tpu_torch.ops import heatmaps
    from skelsplat_tpu_torch.synthetic import synthetic_inputs

    dev = resolve_device(device)
    n = N_JOINTS[scene_type]
    rng = np.random.default_rng(seed + 1000)
    params, cams, profs = [], [], []
    for s in range(n_scenes):
        init, _, p2d, cams_np = synthetic_inputs(
            1, width, height, n_joints=n, seed=seed + s,
            ring=3800.0 + 100.0 * s)
        cam = compat.camera_from_numpy(cams_np, device=dev)
        p = init_params(init[0], scene_type, 3.0, 1.0, device=dev)
        spec = heatmaps.heatmap_spec(p.xyz, p.covariance(),
                                     torch.as_tensor(p2d[0], device=dev),
                                     cam, width, height)
        profs.append(cr.view_profiles(spec, width, height))
        f = {k: getattr(p, k).cpu().numpy() + rng.normal(0.0, sd, (n, w))
             for k, sd, w in (("xyz", 15.0, 3), ("log_scales", 0.3, 3),
                              ("quats", 0.3, 4))}
        f["opacity_logit"] = 1.0 + rng.normal(0.0, 1.0, (n, 1))
        if s == 0 and behind_camera:
            c = cams_np["cam_center"][0].astype(np.float64)
            away = c - f["xyz"].mean(axis=0)
            f["xyz"][4] = c + 300.0 * away / np.linalg.norm(away)
        if s == 0 and beyond_clamp:
            tz = 3000.0
            t = np.array([1.35 * cams_np["tan_fovx"][1] * tz, 0.0, tz, 1.0])
            f["xyz"][7] = (np.linalg.inv(cams_np["view4"][1].astype(
                np.float64)) @ t)[:3]
            f["log_scales"][7] = (6.5, 5.5, 6.0)
        if infinite_logit:
            f["opacity_logit"][:] = np.inf
        params.append(f)
        cams.append(cam)
    params = GaussianParams(*(
        torch.as_tensor(np.stack([f[k] for f in params]), dtype=torch.float32,
                        device=dev) for k in PARAM_FIELDS))
    cameras = Camera(**{k: torch.cat([getattr(c, k) for c in cams])
                        for k in FIELDS})
    prof = cr.ViewProfiles(*(torch.cat(x) for x in zip(*profs)))
    return params, cameras, prof, 4


def autograd_step(params, cameras, prof, A: int, antialiasing: bool,
                  loss_function: str, scene_type: str, consistency: str,
                  lambda_consistency: float):
    """(losses (V,), gradients by field (V,N,·)) of the macro step of
    ``step_inputs``' outputs through autograd of
    ``cuda_raster.make_cuda_view_loss`` with one parameter copy per view:
    the renderer's step before kernels A and B, their reference."""
    from skelsplat_tpu_torch.core.gaussians import (N_JOINTS, PARAM_FIELDS,
                                                    SkeletonModel)
    from skelsplat_tpu_torch.engine.trainer import TrainSettings

    settings = TrainSettings(loss_function=loss_function,
                             consistency_loss=consistency,
                             lambda_consistency=lambda_consistency)
    view_loss = cr.make_cuda_view_loss(
        SkeletonModel(scene_type, N_JOINTS[scene_type]), settings,
        prof.p2.shape[-1], prof.p1.shape[-1], antialiasing)
    copies = params.map(lambda x: x.detach().repeat_interleave(A, dim=0)
                        .requires_grad_(True))
    with torch.enable_grad():
        losses = view_loss(copies, cameras, prof, None)
        grads = torch.autograd.grad(losses.sum(), [getattr(copies, f)
                                                   for f in PARAM_FIELDS])
    return losses.detach(), dict(zip(PARAM_FIELDS, grads))


def keep_slots(pack, p1s, n: int, views=slice(None)):
    """Copies of ``pack`` and ``p1s`` in which slots n.. of ``views`` (every
    view by default) are dead: zero opacity and GT span (K1's tile flags
    never set, so no tile lists them) and a zero GT row profile (gt = B
    <= 0 everywhere, so the plain version agrees: no loss, no gradient)."""
    pack, p1s = pack.clone(), p1s.clone()
    pack[views, n:, cr.IDX_OPA] = 0.0
    pack[views, n:, cr.IDX_GY0:cr.IDX_GX1 + 1] = 0.0
    p1s[views, n:] = 0.0
    return pack, p1s


def time_k1(pack, p1s, p2s, img, reps: int = 200,
            per_kernel: dict | None = None) -> tuple[float, float]:
    """(device ms, back-to-back ms) per K1 call on these inputs; a
    ``per_kernel`` dict gets the ms of each of its kernels."""
    from skelsplat_tpu_torch.tools.timing import cuda_ms

    if pack.device.type != "cuda":
        raise RuntimeError(f"K1 is timed on the GPU; the inputs are on "
                           f"{pack.device}")
    return cuda_ms(lambda: cr.raster_loss_grad(pack, p1s, p2s, img, False),
                   reps=reps, each_kernel_once=True, per_kernel=per_kernel)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dead", action="store_true",
                    help="also time the same launch with every slot dead "
                         "(the launch floor)")
    ap.add_argument("--live-slots", type=int, nargs="+", default=None,
                    metavar="N",
                    help="time with only the first N slots live, for each "
                         "N, and fit time against flagged (tile, slot) pairs")
    args = ap.parse_args(argv)
    from skelsplat_tpu_torch.ops import _build
    from skelsplat_tpu_torch.tools.timing import card_line

    pack, p1s, p2s, img = probe_inputs(device="cuda")
    card = card_line()
    shape = (p1s.shape[-1], p2s.shape[-1])
    n_slots = pack.shape[1]
    occ = _build.occupancy(True, False, _build.slot_bound(n_slots))
    print(f"K1 tile kernel (l2, slot bound "
          f"{_build.slot_bound(n_slots)}): {occ['registers']} registers, "
          f"{occ['local_bytes']} spill bytes a thread, "
          f"{occ['blocks_per_sm']} resident blocks per SM", flush=True)

    timed = {}

    def probe(n, per_kernel=None):
        if n in timed:
            return timed[n]
        pk, p1 = keep_slots(pack, p1s, n)
        pairs = int(tile_activity(pk, img, shape)["flagged_pairs"].sum())
        ms, stream_ms = time_k1(pk, p1, p2s, img, per_kernel=per_kernel)
        print(f"{n:>2} live slots: {pairs:>6} flagged (tile, slot) "
              f"pairs, {ms:.4f} ms/launch device time ({stream_ms:.4f} back "
              f"to back) on {card}", flush=True)
        timed[n] = pairs, ms
        return pairs, ms

    out = {"card": card, "occupancy": occ, "by_kernel": {}}
    out["live_pairs"], out["live_ms"] = probe(n_slots, out["by_kernel"])
    print(f"live launch by kernel: " + ", ".join(
        f"{k.split('(')[0]} {ms:.4f} ms" for k, ms in
        out["by_kernel"].items()), flush=True)
    if args.dead:
        out["dead_pairs"], out["dead_ms"] = probe(0)
        print(f"dead launch = {out['dead_ms'] / out['live_ms']:.3f} of "
              f"the live launch")
    if args.live_slots:
        sweep = [probe(min(n, n_slots)) for n in args.live_slots]
        out["sweep"] = sweep
        if len({p for p, _ in sweep}) >= 2:
            xs = np.array([p for p, _ in sweep], np.float64)
            ys = np.array([t for _, t in sweep], np.float64) * 1e3
            slope, intercept = np.polyfit(xs, ys, 1)
            out["fit_us_per_pair"], out["fit_fixed_us"] = slope, intercept
            print(f"linear fit: {slope * 1e3:.3f} ns per flagged (tile, "
                  f"slot) pair, {intercept:.2f} us fixed per launch "
                  f"({intercept / 1e3 / out['live_ms']:.3f} of the live "
                  f"launch) on {card}")
    return out


if __name__ == "__main__":
    main()
