#!/usr/bin/env python
"""Collect the triangulation entry point's iteration_0 PLYs into the
``initial_guess/triang_*`` npz tree (counterpart of
``skelsplat_tpu/tools/preprocess_triang_initial_guess.py``).

    python -m skelsplat_tpu_torch.tools.preprocess_triang_initial_guess \
        --input_dir experiments/.../point_cloud/iteration_0 \
        --output_dir data/h36m --name triang_metrabs

Files are grouped by the first two ``_`` fields of their name (subject,
activity) and stacked in sorted order; CPN's S11/Directions is skipped.
A Panoptic name such as ``S0_171204_pose5_000012`` therefore lands under
``S0/171204``, as in the reference.
"""

import argparse
import os
from collections import defaultdict

import numpy as np

from skelsplat_tpu_torch.data import ply


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", required=True,
                        help="…/point_cloud/iteration_0 of a triangulation run")
    parser.add_argument("--output_dir", default="data/h36m")
    parser.add_argument("--name", default="triang_gt",
                        help="initial_guess subdirectory name")
    args = parser.parse_args(argv)

    output_3d = os.path.join(args.output_dir, "initial_guess", args.name)
    os.makedirs(output_3d, exist_ok=True)

    grouped = defaultdict(list)
    for entry in os.listdir(args.input_dir):
        if entry.endswith(".ply"):
            parts = entry.split("_")
            if len(parts) >= 2:
                grouped[(parts[0], parts[1])].append(entry)

    for (subject, activity), entries in grouped.items():
        if "cpn" in args.input_dir and subject == "S11" \
                and activity == "Directions":
            continue
        activity_dir = os.path.join(output_3d, subject, activity)
        os.makedirs(activity_dir, exist_ok=True)
        data = [ply.read_xyz(os.path.join(args.input_dir, e))
                for e in sorted(entries)]
        np.savez(os.path.join(activity_dir, "poses.npz"),
                 poses3d=np.array(data))
        print(f"{subject}/{activity}: {len(data)} frames")
    print(f"Done, data saved to {output_3d}")


if __name__ == "__main__":
    main()
