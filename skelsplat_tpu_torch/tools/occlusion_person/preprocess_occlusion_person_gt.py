#!/usr/bin/env python
"""Occlusion-Person pickle annotations → 3d_gt/2d_gt trees + cameras.json
(counterpart of
``skelsplat_tpu/tools/occlusion_person/preprocess_occlusion_person_gt.py``,
with the reference's every-8th-then-every-5th AdaFuse downsampling)."""

import argparse
import json
import os
import pickle as pkl

import numpy as np


def convert_numpy_to_list(obj):
    if isinstance(obj, dict):
        return {k: convert_numpy_to_list(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [convert_numpy_to_list(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pkl_file", required=True)
    parser.add_argument("--output_dir", default="data/occlusion-person")
    args = parser.parse_args(argv)

    with open(args.pkl_file, "rb") as f:
        data = pkl.load(f)

    joints_2d = np.array([d["joints_2d"] for d in data])
    joints_3d = np.array([d["joints_gt"] for d in data])
    camera_list = [d["camera"] for d in data]
    print(f"Loaded {joints_2d.shape} 2D and {joints_3d.shape} 3D joints.")

    for camera_id in range(8):
        out_2d = os.path.join(args.output_dir, "2d_gt", "S0", str(camera_id))
        os.makedirs(out_2d, exist_ok=True)
        p2 = joints_2d[camera_id::8, :, :2][::5]
        np.savez(os.path.join(out_2d, "poses.npz"), poses2d=p2)
        print(f"camera {camera_id}: 2D {p2.shape}")

    out_3d = os.path.join(args.output_dir, "3d_gt", "S0", "validation")
    os.makedirs(out_3d, exist_ok=True)
    p3 = joints_3d[0::8, :, :3][::5]
    np.savez(os.path.join(out_3d, "poses.npz"), poses3d=p3)
    print(f"3D {p3.shape}")

    cameras = {cid: camera_list[cid::8][::5] for cid in range(8)}
    cameras_to_save = {
        f: [convert_numpy_to_list(cameras[cid][f]) for cid in range(8)]
        for f in range(len(cameras[0]))
    }
    with open(os.path.join(args.output_dir, "cameras.json"), "w") as f:
        json.dump(cameras_to_save, f)
    print("cameras.json written")


if __name__ == "__main__":
    main()
