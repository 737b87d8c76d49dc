"""On-card probe of the raster-loss kernel K1 alone
(counterpart of ``skelsplat_tpu/tools/kernel_probe.py``).

Times K1 (``ops/cuda_raster.py::raster_loss_grad``) at the main path's
shapes, 4 views of 1002×1000, 17 slots, l2, on a depth-sorted pack built
through the port's own preprocess and ``slot_pack`` at the initial
parameters of a synthetic H36M frame, and splits its time into fixed cost
and work:

* ``--dead`` kills every slot in the same inputs (zero opacity, zero GT
  span, zero GT row profile), so every tile takes the kernel's empty-tile
  exit (csrc/raster_loss.cu:96-99). That is the launch floor: the grid,
  the zero partials each tile writes, and the per-view reduce kernel.
* ``--live-slots n1 n2 ...`` keeps the first n slots of each view live and
  kills the rest, then fits time against flagged (tile, slot) pairs with
  ``np.polyfit``: the slope is the cost of one flagged pair, the
  intercept the fixed cost of a launch. (The TPU probe swept slot widths,
  which a tile kernel does not have.)

It times a kernel, so it needs the GPU and raises without one. The input
builder ``probe_inputs`` also runs on the CPU.

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
                 n_views: int = N_VIEWS, seed: int = 0, device="cuda"):
    """(pack (V,N,16), p1 (V,N,H), p2 (V,N,W), img (V,2)) of frame 0 of the
    synthetic scenes from ``seed`` at its initial parameters, depth-sorted
    and packed as ``fused_view_loss_cuda`` packs them for K1."""
    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch.core.gaussians import init_params
    from skelsplat_tpu_torch.ops import heatmaps, rasterizer
    from skelsplat_tpu_torch.synthetic import synthetic_inputs

    dev = resolve_device(device)
    init, _, p2d, cams_np = synthetic_inputs(1, width, height,
                                             n_views=n_views,
                                             n_joints=n_joints, seed=seed)
    cams = compat.camera_from_numpy(cams_np, device=dev)
    params = init_params(init[0], "h36m", 3.0, 1.0, device=dev)
    spec = heatmaps.heatmap_spec(params.xyz, params.covariance(),
                                 torch.as_tensor(p2d[0], device=dev), cams,
                                 width, height)
    prof = cr.view_profiles(spec, width, height)
    with torch.no_grad():
        pp = rasterizer.preprocess_gaussians(params.xyz, params.covariance(),
                                             params.opacity, cams, width,
                                             height)
        gd, aux, p1s, p2s = cr.slot_pack(pp, prof)
        pack = torch.cat([gd, aux], dim=-1).contiguous()
    return pack, p1s, p2s, prof.img


def keep_slots(pack, p1s, n: int):
    """Copies of ``pack`` and ``p1s`` in which slots n.. of every view are
    dead: zero opacity and GT span (K1's tile flags never set, so a tile
    with only dead slots exits at once) and a zero GT row profile (gt = B
    <= 0 everywhere, so the plain version agrees: no loss, no gradient)."""
    pack, p1s = pack.clone(), p1s.clone()
    pack[:, n:, cr.IDX_OPA] = 0.0
    pack[:, n:, cr.IDX_GY0:cr.IDX_GX1 + 1] = 0.0
    p1s[:, n:] = 0.0
    return pack, p1s


def time_k1(pack, p1s, p2s, img, reps: int = 200) -> tuple[float, float]:
    """(device ms, back-to-back ms) per K1 launch on these inputs."""
    from skelsplat_tpu_torch.tools.timing import cuda_ms

    if pack.device.type != "cuda":
        raise RuntimeError(f"K1 is timed on the GPU; the inputs are on "
                           f"{pack.device}")
    return cuda_ms(lambda: cr.raster_loss_grad(pack, p1s, p2s, img, False),
                   reps=reps, each_kernel_once=True)


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
    from skelsplat_tpu_torch.tools.timing import card_line

    pack, p1s, p2s, img = probe_inputs(device="cuda")
    card = card_line()
    shape = (p1s.shape[-1], p2s.shape[-1])
    n_slots = pack.shape[1]

    timed = {}

    def probe(n):
        if n in timed:
            return timed[n]
        pk, p1 = keep_slots(pack, p1s, n)
        pairs = int(tile_activity(pk, img, shape)["flagged_pairs"].sum())
        ms, stream_ms = time_k1(pk, p1, p2s, img)
        print(f"{n:>2} live slots: {pairs:>6} flagged (tile, slot) pairs, "
              f"{ms:.4f} ms/launch device time ({stream_ms:.4f} back to "
              f"back) on {card}", flush=True)
        timed[n] = pairs, ms
        return pairs, ms

    out = {"card": card}
    out["live_pairs"], out["live_ms"] = probe(n_slots)
    if args.dead:
        out["dead_pairs"], out["dead_ms"] = probe(0)
        print(f"dead launch = {out['dead_ms'] / out['live_ms']:.3f} of the "
              f"live launch")
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
