#!/usr/bin/env python
"""A/B harness over two result trees (counterpart of
``skelsplat_tpu/tools/ab_harness.py``).

The reference publishes no numbers, so parity is established by running
two pipelines on identical scene windows with the stock configs. This
harness compares two result trees produced over the same scenes (the
reference's CUDA pipeline, the JAX package, the port, or two renderers of
one of them) and reports per-scene MPJPE deltas plus the distribution of
pose disagreements between the two.

    python -m skelsplat_tpu_torch.tools.ab_harness \
        --ours experiments/h36m/<date>/<time> \
        --theirs /path/to/reference/run \
        --gt data/h36m/3d_gt [--iteration 500] [--json out.json]

Both runs must contain point_cloud/iteration_{it}/{scene}.ply with the
reference naming scheme; GT follows the standard npz tree.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from skelsplat_tpu_torch.data import ply


def load_run(run_dir: str, iteration: int):
    d = os.path.join(run_dir, "point_cloud", f"iteration_{iteration}")
    scenes = sorted(os.listdir(d))
    return {s: ply.read_xyz(os.path.join(d, s)) for s in scenes}


def gt_lookup(gt_path: str, scene: str, frame_step: int = 64):
    """{subject}_{activity}_{frame:06d}.ply → GT joints. The scene name
    embeds the FULL-RATE frame id (dataset_readers.py:212-213), which
    indexes the full-rate GT npz directly."""
    stem = scene[:-4] if scene.endswith(".ply") else scene
    parts = stem.split("_")
    subject, frame = parts[0], int(parts[-1])
    activity = "_".join(parts[1:-1])
    npz = os.path.join(gt_path, subject, activity, "poses.npz")
    data = np.load(npz, allow_pickle=True)
    key = "poses" if "poses" in data else "poses3d"
    return np.asarray(data[key][frame])


def compare(ours_dir: str, theirs_dir: str, gt_path: str, iteration: int,
            frame_step: int = 64, print_fn=print):
    ours = load_run(ours_dir, iteration)
    theirs = load_run(theirs_dir, iteration)
    common = sorted(set(ours) & set(theirs))
    if not common:
        raise SystemExit("no common scenes between the two runs")
    missing = sorted(set(ours) ^ set(theirs))
    if missing:
        print_fn(f"WARNING: {len(missing)} scenes present in only one run")

    rows = []
    for scene in common:
        a, b = ours[scene], theirs[scene]
        try:
            gt = gt_lookup(gt_path, scene, frame_step)
        except Exception:
            gt = None
        row = {
            "scene": scene,
            "pose_disagreement_mm": float(
                np.linalg.norm(a - b, axis=1).mean()),
        }
        if gt is not None and gt.shape == a.shape:
            row["ours_mpjpe"] = float(np.linalg.norm(a - gt, axis=1).mean())
            row["theirs_mpjpe"] = float(np.linalg.norm(b - gt, axis=1).mean())
            row["mpjpe_delta"] = row["ours_mpjpe"] - row["theirs_mpjpe"]
        rows.append(row)

    dis = np.array([r["pose_disagreement_mm"] for r in rows])
    summary = {
        "n_scenes": len(rows),
        "pose_disagreement_mm": {
            "mean": float(dis.mean()), "median": float(np.median(dis)),
            "p95": float(np.percentile(dis, 95)), "max": float(dis.max())},
    }
    deltas = [r["mpjpe_delta"] for r in rows if "mpjpe_delta" in r]
    if deltas:
        deltas = np.array(deltas)
        summary["mpjpe"] = {
            "ours_mean": float(np.mean([r["ours_mpjpe"] for r in rows
                                        if "ours_mpjpe" in r])),
            "theirs_mean": float(np.mean([r["theirs_mpjpe"] for r in rows
                                          if "theirs_mpjpe" in r])),
            "delta_mean": float(deltas.mean()),
            "delta_p95_abs": float(np.percentile(np.abs(deltas), 95)),
            "within_half_mm": float(np.mean(np.abs(deltas) <= 0.5)),
        }
    print_fn(json.dumps(summary, indent=2))
    return {"summary": summary, "scenes": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ours", required=True)
    ap.add_argument("--theirs", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--iteration", type=int, default=500)
    ap.add_argument("--frame-step", type=int, default=64)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = compare(args.ours, args.theirs, args.gt, args.iteration,
                  args.frame_step)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
