#!/usr/bin/env python
"""Cross-renderer parity study (counterpart of
``skelsplat_tpu/tools/parity_study.py``): the dense autograd oracle
(``ops/rasterizer.py``), the autograd row-chunk stream (``ops/fused.py``)
and the hand-written kernel (``ops/cuda_raster.py``, its plain version on
the CPU), each run through the full optimization of the same synthetic
scenes (``synthetic.py``, seed 0: 4 views, stock budgets) and compared
pairwise with ``tools/ab_harness``.

    python -m skelsplat_tpu_torch.tools.parity_study [--scenes 3]
        [--preset h36m|panoptic|op] [--renderers dense fused cuda]
        [--iterations 500] [--out DIR] [--device cuda|cpu] [--json PATH]

Prints each renderer's MPJPE and each pair's max/mean pose disagreement
(mm), and returns them. The port has no windowed tier, so the JAX tool's
``pallas-windowed`` renderer has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import os
import time

PRESETS = {"h36m": (1002, 1000, 17, "h36m"),
           "panoptic": (1920, 1080, 19, "panoptic"),
           "op": (1280, 720, 15, "occlusion-person")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--preset", default="h36m", choices=sorted(PRESETS),
                    help="dataset scale (image size, joint count, skeleton)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--out", default=os.path.join("build", "parity"))
    ap.add_argument("--renderers", nargs="+",
                    default=["dense", "fused", "cuda"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import numpy as np

    from skelsplat_tpu_torch import resolve_device

    resolve_device(args.device)     # raises before anything is written

    from skelsplat_tpu_torch.core.cameras import camera_from_arrays
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.data import ply
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings
    from skelsplat_tpu_torch.synthetic import synthetic_inputs
    from skelsplat_tpu_torch.tools import ab_harness

    W, H, n_joints, scene_type = PRESETS[args.preset]
    W = args.width or W
    H = args.height or H
    K = args.scenes
    init, gt, p2d, cams_np = synthetic_inputs(K, W, H, n_joints=n_joints)
    cams = camera_from_arrays(cams_np, device="cpu")
    model = SkeletonModel(scene_type, n_joints, scaling=3.0)
    opt = OptConfig(iterations=args.iterations)

    # GT npz tree for ab_harness's MPJPE columns (scene s ↔ frame id s)
    gt_root = os.path.join(args.out, "3d_gt")
    os.makedirs(os.path.join(gt_root, "S1", "Synth"), exist_ok=True)
    np.savez(os.path.join(gt_root, "S1", "Synth", "poses.npz"), poses=gt)
    names = [f"S1_Synth_{s:06d}" for s in range(K)]

    results = {}
    for r in args.renderers:
        tr = SceneTrainer(model, opt, TrainSettings(), W, H, renderer=r,
                          device=args.device)
        d = os.path.join(args.out, r, "point_cloud",
                         f"iteration_{args.iterations}")
        os.makedirs(d, exist_ok=True)
        errs, t0 = [], time.perf_counter()
        for s in range(K):
            params, _ = tr.optimize_scene(init[s], p2d[s], cams, gt[s])
            host = [getattr(params, f).cpu().numpy() for f in
                    ("xyz", "log_scales", "quats", "opacity_logit")]
            errs.append(float(np.linalg.norm(host[0] - gt[s], axis=1).mean()))
            ply.write_gaussian_ply(os.path.join(d, names[s] + ".ply"), *host)
        dt = time.perf_counter() - t0
        results[r] = {"mpjpe_mm": errs, "seconds": dt}
        print(f"[{r}] MPJPE {np.mean(errs):.4f} mm "
              f"(per-scene {['%.4f' % e for e in errs]}), {dt:.1f}s total")

    ran = [r for r in args.renderers if r in results]
    pair_rows = {}
    for i in range(len(ran)):
        for j in range(i + 1, len(ran)):
            a, b = ran[i], ran[j]
            print(f"\n=== ab_harness: {a} vs {b} ===")
            out = ab_harness.compare(
                os.path.join(args.out, a), os.path.join(args.out, b),
                gt_root, args.iterations)
            dis = [r_["pose_disagreement_mm"] for r_ in out["scenes"]]
            pair_rows[f"{a}_vs_{b}"] = {
                "max_disagreement_mm": max(dis),
                "mean_disagreement_mm": float(np.mean(dis)),
            }
    print("\nsummary:", json.dumps(pair_rows, indent=1))
    report = {"renderers": results, "pairs": pair_rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
