#!/usr/bin/env python
"""CMU Panoptic hdPose3d COCO19 json → 3d_gt + reprojected 2d_gt trees
(counterpart of ``skelsplat_tpu/tools/panoptic/preprocess_panoptic_gt.py``;
the reprojection stays numpy float64, so the 2D GT is bitwise the JAX
tool's)."""

import argparse
import json
import os

import numpy as np

from skelsplat_tpu_torch.data.cameras_io import PANOPTIC_CAMERAS


def get_camera_params(path, cameras):
    with open(path) as f:
        calib_data = json.load(f)
    out = {}
    for camera in cameras:
        for params in calib_data["cameras"]:
            if params["name"] == camera:
                out[camera] = {
                    "intrinsics": params["K"],
                    "rotation": params["R"],
                    "translation": params["t"],
                    "distortion": params["distCoef"],
                }
                break
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True,
                        help="path to the panoptic-toolbox root")
    parser.add_argument("--sequences", nargs="+",
                        default=["171204_pose5", "171204_pose6"])
    parser.add_argument("--output", default="data/panoptic")
    parser.add_argument("--cameras", nargs="+", default=PANOPTIC_CAMERAS)
    args = parser.parse_args(argv)

    for seq in args.sequences:
        skeleton_path = os.path.join(args.input, seq, "hdPose3d_stage1_coco19")
        calib_file = os.path.join(args.input, seq,
                                  f"calibration_{seq}.json")
        camera_parameters = get_camera_params(calib_file, args.cameras)

        poses_3d = []
        poses_2d = {cam: [] for cam in args.cameras}
        for file in sorted(os.listdir(skeleton_path)):
            if not file.endswith(".json"):
                continue
            try:
                with open(os.path.join(skeleton_path, file)) as f:
                    data = json.load(f)
            except Exception:
                print("Error loading file:", file)
                continue
            if len(data["bodies"]) == 0:
                print("No skeletons found in file:", file)
                continue
            for skeleton in data["bodies"]:
                joints = np.array(skeleton["joints19"]).reshape(19, 4)
                poses_3d.append(joints[:, :3])
                for camera in args.cameras:
                    K = np.asarray(camera_parameters[camera]["intrinsics"])
                    R = np.asarray(camera_parameters[camera]["rotation"])
                    t = np.asarray(camera_parameters[camera]["translation"])
                    p = K @ (R @ joints[:, :3].T + t)
                    poses_2d[camera].append((p[:2] / p[2]).T)

        for camera in args.cameras:
            out_2d = os.path.join(args.output, "2d_gt", "S0", seq, camera)
            os.makedirs(out_2d, exist_ok=True)
            np.savez(os.path.join(out_2d, "poses.npz"),
                     poses=np.array(poses_2d[camera]))
        out_3d = os.path.join(args.output, "3d_gt", "S0", seq)
        os.makedirs(out_3d, exist_ok=True)
        np.savez(os.path.join(out_3d, "poses.npz"), poses=np.array(poses_3d))
        print(f"{seq}: {len(poses_3d)} skeletons")
        # copy the calibration next to the GT for the loaders
        cam_dir = os.path.join(args.output, "3d_gt", "cameras")
        os.makedirs(cam_dir, exist_ok=True)
        with open(calib_file) as f:
            cal = f.read()
        with open(os.path.join(cam_dir, f"calibration_{seq}.json"), "w") as f:
            f.write(cal)


if __name__ == "__main__":
    main()
