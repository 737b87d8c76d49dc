#!/usr/bin/env python
"""MeTRAbs per-view 2D + monocular-3D predictions → 2d_metrabs /
3d_metrabs_mono trees
(counterpart of
``skelsplat_tpu/tools/h36m/preprocess_metrabs_predictions.py``, with the
reference's hardcoded S9/S11 activity orders and frame counts)."""

import argparse
import os

import numpy as np

from skelsplat_tpu_torch.data.cameras_io import H36M_CAMERAS

ACTIVITIES_S9 = [
    "Directions", "Directions 1", "Discussion 1", "Discussion 2", "Eating",
    "Eating 1", "Greeting", "Greeting 1", "Phoning", "Phoning 1", "Photo",
    "Photo 1", "Posing", "Posing 1", "Purchases", "Purchases 1", "Sitting",
    "Sitting 1", "SittingDown", "SittingDown 1", "Smoking", "Smoking 1",
    "Waiting", "Waiting 1", "WalkDog", "WalkDog 1", "WalkTogether",
    "WalkTogether 1", "Walking", "Walking 1",
]
ACTIVITIES_S11 = [
    "Directions", "Directions 1", "Discussion 1", "Discussion 2", "Eating",
    "Eating 1", "Greeting", "Greeting 2", "Phoning 2", "Phoning 3", "Photo",
    "Photo 1", "Posing", "Posing 1", "Purchases", "Purchases 1", "Sitting",
    "Sitting 1", "SittingDown", "SittingDown 1", "Smoking", "Smoking 2",
    "Waiting", "Waiting 1", "WalkDog", "WalkDog 1", "WalkTogether",
    "WalkTogether 1", "Walking", "Walking 1",
]
ACTIVITIES_LENGTH = [
    43, 37, 92, 83, 42, 42, 23, 43, 52, 60, 37, 23, 31, 31, 24, 20, 47, 48,
    46, 25, 68, 69, 52, 26, 35, 35, 27, 27, 26, 39, 29, 25, 42, 35, 35, 36,
    29, 27, 55, 53, 32, 25, 22, 24, 17, 17, 35, 30, 29, 32, 38, 44, 36, 36,
    23, 19, 22, 29, 26, 26,
]


def preprocess_2d(input_dir: str, output_root: str):
    output_2d = os.path.join(output_root, "2d_metrabs")
    os.makedirs(output_2d, exist_ok=True)
    if not os.path.isdir(input_dir):
        raise FileNotFoundError(input_dir)
    for subject in sorted(os.listdir(input_dir)):
        subject_path = os.path.join(input_dir, subject)
        if not os.path.isdir(subject_path):
            continue
        for activity in sorted(os.listdir(subject_path)):
            activity_path = os.path.join(subject_path, activity)
            if not os.path.isdir(activity_path):
                continue
            poses2d = np.load(os.path.join(activity_path,
                                           "poses2d.npz"))["poses2d"]
            for i, cam_name in enumerate(H36M_CAMERAS):
                out = os.path.join(output_2d, subject, activity, cam_name)
                os.makedirs(out, exist_ok=True)
                np.savez(os.path.join(out, "poses.npz"),
                         poses2d=poses2d[i])
            print(f"Wrote: {subject}/{activity}")
    print("2D Done.")


def preprocess_3d(preds_3d_file: str, output_root: str):
    output_3d = os.path.join(output_root, "3d_metrabs_mono")
    os.makedirs(output_3d, exist_ok=True)
    data = np.load(preds_3d_file)
    if "coords3d_pred_world" not in data:
        raise KeyError(f"'coords3d_pred_world' not in {preds_3d_file}")
    poses3d = data["coords3d_pred_world"]

    cnt = cnt_activity = 0
    for subject in ("S9", "S11"):
        activities = ACTIVITIES_S9 if subject == "S9" else ACTIVITIES_S11
        for activity in activities:
            act_len = ACTIVITIES_LENGTH[cnt_activity]
            preds_activity = poses3d[cnt:cnt + act_len * 4]
            for i, cam_name in enumerate(H36M_CAMERAS):
                out = os.path.join(output_3d, subject, activity, cam_name)
                os.makedirs(out, exist_ok=True)
                np.savez(os.path.join(out, "poses.npz"),
                         poses3d=preds_activity[i * act_len:(i + 1) * act_len])
            cnt += act_len * 4
            cnt_activity += 1
            print(f"3D: {subject}/{activity} ({act_len} frames x 4 cams)")
    print("3D Done.")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--preds_3d", required=True)
    parser.add_argument("--output_dir", default="data/h36m")
    args = parser.parse_args(argv)
    preprocess_2d(args.input_dir, args.output_dir)
    preprocess_3d(args.preds_3d, args.output_dir)


if __name__ == "__main__":
    main()
