#!/usr/bin/env python
"""Panoptic MeTRAbs predictions → per-camera trees
(counterpart of
``skelsplat_tpu/tools/panoptic/preprocess_metrabs_predictions.py``: a pure
directory reshuffle copying poses3d_world.npz / poses2d.npz per camera)."""

import argparse
import os
import shutil


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--output_dir", default="data/panoptic")
    parser.add_argument("--path_3d", default="3d_metrabs_mono")
    parser.add_argument("--path_2d", default="2d_metrabs")
    parser.add_argument("--activities", nargs="+",
                        default=["171204_pose5", "171204_pose6"])
    args = parser.parse_args(argv)

    for activity in args.activities:
        input_path = os.path.join(args.input_dir, activity)
        for camera in os.listdir(input_path):
            d3 = os.path.join(args.output_dir, args.path_3d, "S0", activity,
                              camera)
            d2 = os.path.join(args.output_dir, args.path_2d, "S0", activity,
                              camera)
            os.makedirs(d3, exist_ok=True)
            os.makedirs(d2, exist_ok=True)
            shutil.copy2(os.path.join(input_path, camera, "poses3d_world.npz"),
                         os.path.join(d3, "poses.npz"))
            shutil.copy2(os.path.join(input_path, camera, "poses2d.npz"),
                         os.path.join(d2, "poses.npz"))
    print(f"Processed activities: {args.activities}")


if __name__ == "__main__":
    main()
