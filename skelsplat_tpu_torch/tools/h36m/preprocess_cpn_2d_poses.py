#!/usr/bin/env python
"""CPN 2D detections → per-camera 2d_cpn tree
(counterpart of ``skelsplat_tpu/tools/h36m/preprocess_cpn_2d_poses.py``)."""

import argparse
import os

import numpy as np

from skelsplat_tpu_torch.data.cameras_io import H36M_CAMERAS


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_file", required=True,
                        help="positions_2d.npy from data_2d_h36m_cpn_ft_h36m_dbb")
    parser.add_argument("--output_dir", default="data/h36m")
    parser.add_argument("--frame_step", type=int, default=64)
    args = parser.parse_args(argv)

    output_2d = os.path.join(args.output_dir, "2d_cpn")
    os.makedirs(output_2d, exist_ok=True)
    data_cpn = np.load(args.input_file, allow_pickle=True).item()

    for subject in ["S9", "S11"]:
        for activity in sorted(data_cpn[subject].keys()):
            poses_2d = data_cpn[subject][activity]
            for i, cam_name in enumerate(H36M_CAMERAS):
                out = os.path.join(output_2d, subject, activity, cam_name)
                os.makedirs(out, exist_ok=True)
                poses_cam = np.array(poses_2d[i]).reshape(-1, 17, 2)
                step = np.array([poses_cam[j] for j in
                                 range(0, len(poses_cam), args.frame_step)])
                np.savez(os.path.join(out, "poses.npz"), poses2d=step)
            print(f"{subject}/{activity} done")


if __name__ == "__main__":
    main()
