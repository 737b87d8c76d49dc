#!/usr/bin/env python
"""AdaFuse-ResNet 2D predictions → 2d_resnet tree
(counterpart of ``skelsplat_tpu/tools/h36m/preprocess_resnet_2d_poses.py``,
including the
hardcoded per-activity frame counts the flat prediction file is split by)."""

import argparse
import os

import numpy as np

from skelsplat_tpu_torch.data.cameras_io import H36M_CAMERAS

ACTIVITIES_S9 = [
    "Directions 1", "Directions", "Discussion 1", "Discussion 2", "Eating 1",
    "Eating", "Greeting 1", "Greeting", "Phoning 1", "Phoning", "Posing 1",
    "Posing", "Purchases 1", "Purchases", "Sitting 1", "Sitting",
    "SittingDown", "SittingDown 1", "Smoking 1", "Smoking", "Photo 1",
    "Photo", "Waiting 1", "Waiting", "Walking 1", "Walking", "WalkDog 1",
    "WalkDog", "WalkTogether 1", "WalkTogether",
]
ACTIVITIES_S11 = [
    "Directions 1", "Directions", "Discussion 1", "Discussion 2", "Eating 1",
    "Eating", "Greeting 2", "Greeting", "Phoning 3", "Phoning 2", "Posing 1",
    "Posing", "Purchases 1", "Purchases", "Sitting 1", "Sitting",
    "SittingDown", "SittingDown 1", "Smoking 2", "Smoking", "Photo 1",
    "Photo", "Waiting 1", "Waiting", "Walking 1", "Walking", "WalkDog 1",
    "WalkDog", "WalkTogether 1", "WalkTogether",
]
ACTIVITIES_LENGTH = [
    37, 43, 92, 83, 42, 42, 43, 23, 60, 52, 31, 31, 20, 24, 48, 47, 46, 25,
    69, 68, 23, 37, 26, 52, 39, 26, 35, 35, 27, 27, 25, 29, 42, 35, 36, 35,
    27, 29, 53, 55, 24, 22, 17, 17, 30, 35, 29, 32, 44, 38, 25, 32, 36, 36,
    26, 26, 19, 23, 29, 22,
]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_file", required=True)
    parser.add_argument("--output_dir", default="data/h36m")
    args = parser.parse_args(argv)

    output_2d = os.path.join(args.output_dir, "2d_resnet")
    os.makedirs(output_2d, exist_ok=True)
    data = np.load(args.input_file, allow_pickle=True)
    if "preds" not in data:
        raise ValueError("Input file does not contain 'preds' key.")
    preds = data["preds"]

    cnt = cnt_activity = 0
    for subject in ("S9", "S11"):
        activities = ACTIVITIES_S9 if subject == "S9" else ACTIVITIES_S11
        for activity in activities:
            length = ACTIVITIES_LENGTH[cnt_activity]
            preds_activity = preds[cnt:cnt + length * 4]
            cnt += length * 4
            cnt_activity += 1
            for i, cam_name in enumerate(H36M_CAMERAS):
                out = os.path.join(output_2d, subject, activity, cam_name)
                os.makedirs(out, exist_ok=True)
                np.savez(os.path.join(out, "poses.npz"),
                         poses2d=preds_activity[i::4, :, :2])
            print(f"{subject}/{activity}: {len(preds_activity)} preds")


if __name__ == "__main__":
    main()
