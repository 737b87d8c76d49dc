#!/usr/bin/env python
"""JSON pose dumps → npz (counterpart of
``skelsplat_tpu/tools/extract_poses_from_json.py``)."""

import argparse
import json
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("input_json")
    parser.add_argument("output_dir")
    parser.add_argument("--n-joints", type=int, default=17)
    args = parser.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    with open(args.input_json) as f:
        data = json.load(f)
    poses3d = np.array([item["poses3d_world"] for item in data],
                       dtype=np.float32).reshape(-1, args.n_joints, 3)
    out = os.path.join(args.output_dir, "h36m_preds.npz")
    np.savez(out, coords3d_pred_world=poses3d)
    print(f"Saved 3D pose data to {out}")


if __name__ == "__main__":
    main()
