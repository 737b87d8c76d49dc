#!/usr/bin/env python
"""Monocular-fusion initial guess for H36M (counterpart of
``skelsplat_tpu/tools/h36m/compute_initial_guess.py``; the fusion runs on
``--device``, the card by default).

    python -m skelsplat_tpu_torch.tools.h36m.compute_initial_guess \
        --root_dir data/h36m --preds_3d 3d_metrabs_mono --preds_2d 2d_resnet \
        --output_name initial_guess/metrabs_resnet [--device cpu]
"""

import argparse
import json
import os

import numpy as np

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.tools.initial_guess import fuse_poses
from skelsplat_tpu_torch.triangulate import (create_projection_matrix_h36m,
                                             get_calibration_matrices_h36m,
                                             get_extrinsics_h36m)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", default="data/h36m")
    parser.add_argument("--preds_3d", default="3d_metrabs_mono")
    parser.add_argument("--preds_2d", default="2d_resnet")
    parser.add_argument("--output_name", default="initial_guess/metrabs_resnet")
    parser.add_argument("--device", default="cuda",
                        help="device of the fusion (cuda or cpu)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    output_root = os.path.join(args.root_dir, args.output_name)
    os.makedirs(output_root, exist_ok=True)
    meta = os.path.join(args.root_dir, "3d_gt", "cameras",
                        "camera-parameters.json")
    with open(meta) as f:
        camera_data = json.load(f)
    K_cameras = get_calibration_matrices_h36m(camera_data)

    for subject in os.listdir(os.path.join(args.root_dir, args.preds_3d)):
        subject_path = os.path.join(args.root_dir, args.preds_3d, subject)
        for activity in sorted(os.listdir(subject_path)):
            activity_path = os.path.join(subject_path, activity)
            if not os.path.isdir(activity_path):
                continue
            p3, p2 = [], []
            for cam_name in sorted(os.listdir(activity_path)):
                cam3 = os.path.join(activity_path, cam_name, "poses.npz")
                cam2 = os.path.join(args.root_dir, args.preds_2d, subject,
                                    activity, cam_name, "poses.npz")
                if not (os.path.isdir(os.path.join(activity_path, cam_name))
                        and os.path.exists(cam3) and os.path.exists(cam2)):
                    continue
                p3.append(np.load(cam3)["poses3d"])
                p2.append(np.load(cam2)["poses2d"])
            if not p3:
                continue
            R_c, t_c = get_extrinsics_h36m(camera_data, subject)
            P = create_projection_matrix_h36m(K_cameras, R_c, t_c)
            fused = fuse_poses(np.stack(p3), np.stack(p2)[..., :2], P,
                               device=device)
            out = os.path.join(output_root, subject, activity)
            os.makedirs(out, exist_ok=True)
            np.savez(os.path.join(out, "poses.npz"), poses3d=fused)
            print(f"Processed {subject}/{activity} -> {out}/poses.npz")


if __name__ == "__main__":
    main()
