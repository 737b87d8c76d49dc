#!/usr/bin/env python
"""H36M GT CDF → npz trees (counterpart of
``skelsplat_tpu/tools/h36m/preprocess_h36m_gt.py``).

Selects the 17 relevant of 32 joints and writes ``3d_gt``/``2d_gt`` trees
plus bounding boxes. CDF reading needs ``cdflib`` (not bundled here); the
import is gated so the rest of the tooling works without it.
"""

import argparse
import os

import numpy as np

# 17 of the 32 H36M joints (reference :21)
I_RELEVANT_JOINTS = [0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27]


def process_cdf_to_npz(cdf_path, save_path):
    try:
        import cdflib
    except ImportError as e:
        raise SystemExit(
            "cdflib is required to read H36M CDF files; install it or "
            "convert the CDFs to npz elsewhere") from e
    cdf_data = cdflib.CDF(cdf_path)
    keys = cdf_data.cdf_info().zVariables
    if not keys:
        print(f"Warning: No variables found in {cdf_path}")
        return
    pose_data = cdf_data.varget(keys[0])
    if "3d" in save_path:
        pose_data = pose_data.reshape(-1, 32, 3)
    else:
        pose_data = pose_data.reshape(-1, 32, 2)
    pose_data = pose_data[:, I_RELEVANT_JOINTS, :]
    np.savez_compressed(save_path, poses=pose_data)
    print(f"Saved {save_path}")


def process_npy_to_npz(npy_path, save_path):
    data = np.load(npy_path)
    np.savez_compressed(save_path, boxes=data)
    print(f"Saved {save_path}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", required=True)
    parser.add_argument("--output_dir", default="data/h36m")
    args = parser.parse_args(argv)

    output_3d = os.path.join(args.output_dir, "3d_gt")
    output_2d = os.path.join(args.output_dir, "2d_gt")
    os.makedirs(output_3d, exist_ok=True)
    os.makedirs(output_2d, exist_ok=True)

    for subject in sorted(os.listdir(args.root_dir)):
        subject_path = os.path.join(args.root_dir, subject)
        if not os.path.isdir(subject_path) or not subject.startswith("S"):
            continue
        d3 = os.path.join(subject_path, "MyPoseFeatures", "D3_Positions")
        if os.path.exists(d3):
            for cdf_file in os.listdir(d3):
                if not cdf_file.endswith(".cdf"):
                    continue
                action = os.path.splitext(cdf_file)[0]
                out = os.path.join(output_3d, subject, action)
                os.makedirs(out, exist_ok=True)
                process_cdf_to_npz(os.path.join(d3, cdf_file),
                                   os.path.join(out, "poses.npz"))
        d2 = os.path.join(subject_path, "MyPoseFeatures", "D2_Positions")
        if os.path.exists(d2):
            for cdf_file in os.listdir(d2):
                if not cdf_file.endswith(".cdf"):
                    continue
                parts = cdf_file.split(".")
                if len(parts) < 3:
                    print(f"Skipping malformed filename: {cdf_file}")
                    continue
                action, camera_code = parts[0], parts[1]
                out = os.path.join(output_2d, subject, action, camera_code)
                os.makedirs(out, exist_ok=True)
                process_cdf_to_npz(os.path.join(d2, cdf_file),
                                   os.path.join(out, "poses.npz"))
        bb = os.path.join(subject_path, "BBoxes")
        if os.path.exists(bb):
            for npy_file in os.listdir(bb):
                if not npy_file.endswith(".npy"):
                    continue
                parts = npy_file.split(".")
                if len(parts) < 3:
                    continue
                action, camera_code = parts[0], parts[1]
                out = os.path.join(output_2d, subject, action, camera_code)
                os.makedirs(out, exist_ok=True)
                process_npy_to_npz(os.path.join(bb, npy_file),
                                   os.path.join(out, "boxes.npz"))


if __name__ == "__main__":
    main()
