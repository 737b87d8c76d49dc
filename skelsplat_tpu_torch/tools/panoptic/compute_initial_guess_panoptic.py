#!/usr/bin/env python
"""Monocular-fusion initial guess for CMU Panoptic (counterpart of
``skelsplat_tpu/tools/panoptic/compute_initial_guess_panoptic.py``): the
H36M tool's fusion, on ``--device``, over the per-activity calibrations
and ``poses_filtered{suffix}.npz`` inputs.

    python -m skelsplat_tpu_torch.tools.panoptic.compute_initial_guess_panoptic \
        --root_dir data/panoptic --filtered_suffix _4 [--device cpu]

As in the reference, the fusion takes the first ``len(cameras read)`` of
the sorted projection matrices, whichever cameras were skipped.
"""

import argparse
import json
import os

import numpy as np

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.tools.initial_guess import fuse_poses
from skelsplat_tpu_torch.triangulate import (create_projection_matrix,
                                             get_camera_parameters_panoptic)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", default="data/panoptic")
    parser.add_argument("--preds_3d", default="3d_metrabs_mono")
    parser.add_argument("--preds_2d", default="2d_metrabs")
    parser.add_argument("--output_name", default="initial_guess/metrabs")
    parser.add_argument("--filtered_suffix", default="",
                        help="e.g. '_4' to use poses_filtered_4.npz")
    parser.add_argument("--nviews", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="device of the fusion (cuda or cpu)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    output_root = os.path.join(args.root_dir, args.output_name)
    os.makedirs(output_root, exist_ok=True)
    fname = (f"poses_filtered{args.filtered_suffix}.npz"
             if args.filtered_suffix else "poses_filtered.npz")

    camera_data = {}
    preds_root = os.path.join(args.root_dir, args.preds_3d)
    for subject in os.listdir(preds_root):
        subject_path = os.path.join(preds_root, subject)
        for activity in sorted(os.listdir(subject_path)):
            activity_path = os.path.join(subject_path, activity)
            if not os.path.isdir(activity_path):
                continue
            if activity not in camera_data:
                meta = os.path.join(args.root_dir, "3d_gt", "cameras",
                                    f"calibration_{activity}.json")
                with open(meta) as f:
                    camera_data[activity] = json.load(f)
            p3, p2 = [], []
            for cam_name in sorted(os.listdir(activity_path)):
                f3 = os.path.join(activity_path, cam_name, fname)
                f2 = os.path.join(args.root_dir, args.preds_2d, subject,
                                  activity, cam_name, fname)
                if not (os.path.exists(f3) and os.path.exists(f2)):
                    continue
                p3.append(np.load(f3, allow_pickle=True)["poses"])
                p2.append(np.load(f2, allow_pickle=True)["poses"])
            if not p3:
                continue
            K_c, R_c, t_c = get_camera_parameters_panoptic(
                camera_data[activity], args.nviews)
            P = create_projection_matrix(K_c, R_c, t_c)
            fused = fuse_poses(np.stack(p3), np.stack(p2)[..., :2],
                               P[: len(p3)], device=device)
            out = os.path.join(output_root, subject, activity)
            os.makedirs(out, exist_ok=True)
            np.savez(os.path.join(out, "poses.npz"), poses3d=fused)
            print(f"Processed {subject}/{activity}")


if __name__ == "__main__":
    main()
