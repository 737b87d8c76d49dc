#!/usr/bin/env python
"""Occlusion-Person ResNet 2D predictions → 2d_resnet tree
(counterpart of
``skelsplat_tpu/tools/occlusion_person/preprocess_resnet_2d_poses.py``)."""

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_file", required=True)
    parser.add_argument("--output_dir", default="data/occlusion-person")
    args = parser.parse_args(argv)

    output_2d = os.path.join(args.output_dir, "2d_resnet")
    data = np.load(args.input_file, allow_pickle=True)
    if "preds" not in data:
        raise ValueError("Input file does not contain 'preds' key.")
    preds = data["preds"]
    print(f"Loaded {preds.shape} predictions")

    subject_path = os.path.join(output_2d, "S0", "validation")
    for cam_id in range(8):
        cam_path = os.path.join(subject_path, str(cam_id))
        os.makedirs(cam_path, exist_ok=True)
        poses2d = preds[cam_id::8, :, :2]
        np.savez(os.path.join(cam_path, "poses.npz"), poses2d=poses2d)
        print(f"camera {cam_id}: {poses2d.shape}")


if __name__ == "__main__":
    main()
