#!/usr/bin/env python
"""Filter Panoptic samples to those valid in ALL selected views
(counterpart of
``skelsplat_tpu/tools/panoptic/filter_preds_number_views.py``, which
ported the reference's dataset_tools/panoptic/filter_preds_number_views.py).

For each activity, the per-view 3D mono predictions decide validity: a
frame survives only if every selected view has a prediction (not None)
with no NaNs. Surviving frames of the 3D/2D predictions and 2D GT are
written per view, plus one shared 3D GT file, as
``poses_filtered_{nviews}.npz``. GT poses are scaled x10 (dm -> cm,
reference :72-74) at write time.

Intentional divergence from the reference: the x10 GT scaling is keyed to
the gt2d/gt3d ROLE arguments here, while the reference keys on the
substring 'gt' appearing in the destination path (reference :74) — so
with non-default folder names (e.g. a --preds3d_name containing 'gt', or
a GT folder named without 'gt') the reference would scale different
files. Role-based scaling is the intended semantics; defaults behave
identically.
"""

import argparse
import os
import sys

import numpy as np

from skelsplat_tpu_torch.data.cameras_io import PANOPTIC_CAMERAS


def read_poses(path, key="poses"):
    """Load one array from an npz, tolerating object dtype (None entries)."""
    with np.load(path, allow_pickle=True) as archive:
        try:
            return archive[key]
        except KeyError:
            raise KeyError(f"{path}: npz has no '{key}' entry "
                           f"(keys: {sorted(archive.files)})")


def _view_mask(poses):
    """Per-frame validity for ONE view: present and NaN-free."""
    n = poses.shape[0]
    if poses.dtype != object:
        flat = poses.reshape(n, -1)
        return ~np.isnan(flat).any(axis=1)
    ok = np.empty(n, dtype=bool)
    for i in range(n):
        entry = poses[i]
        ok[i] = entry is not None and not np.isnan(np.asarray(entry)).any()
    return ok


def joint_valid_indices(view_arrays):
    """Frame indices valid in EVERY view (AND of the per-view masks)."""
    if len(view_arrays) == 0:
        raise ValueError("No view arrays provided.")
    counts = {a.shape[0] for a in view_arrays}
    if len(counts) != 1:
        raise ValueError(f"Inconsistent sample counts: "
                         f"{[a.shape[0] for a in view_arrays]}")
    joint = np.logical_and.reduce([_view_mask(a) for a in view_arrays])
    return np.flatnonzero(joint)


def write_filtered(src_file, dst_file, indices, key="poses", scale=1.0):
    """Write the kept frames (as float64, optionally scaled) under 'poses'."""
    # asarray (not astype) so object arrays of uniform poses stack densely
    kept = np.asarray(list(read_poses(src_file, key)[indices]),
                      dtype=np.float64)
    if scale != 1.0:
        kept = kept * scale
    parent = os.path.dirname(dst_file)
    if parent:
        os.makedirs(parent, exist_ok=True)
    np.savez(dst_file, poses=kept)
    return kept.shape


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", default="data/panoptic")
    parser.add_argument("--activities", nargs="+",
                        default=["171204_pose5", "171204_pose6"])
    parser.add_argument("--nviews", type=int, default=4)
    parser.add_argument("--cameras", nargs="*", default=PANOPTIC_CAMERAS)
    parser.add_argument("--preds3d_name", default="3d_metrabs_mono")
    parser.add_argument("--preds2d_name", default="2d_metrabs")
    parser.add_argument("--gt2d_name", default="2d_gt")
    parser.add_argument("--gt3d_name", default="3d_gt")
    args = parser.parse_args(argv)

    camera_names = args.cameras[: args.nviews]
    nv = len(camera_names)
    # (folder name, write scale) -- GT converted to cm on write.
    per_view_roles = [(args.preds3d_name, 1.0), (args.preds2d_name, 1.0),
                      (args.gt2d_name, 10.0)]
    for activity in args.activities:
        act_dir = lambda name, *rest: os.path.join(  # noqa: E731
            args.data_path, name, "S0", activity, *rest)
        try:
            preds_views = [read_poses(act_dir(args.preds3d_name, cam,
                                              "poses.npz"))
                           for cam in camera_names]
        except (FileNotFoundError, KeyError) as e:
            print(f"[ERROR] {e}", file=sys.stderr)
            continue
        keep = joint_valid_indices(preds_views)
        print(f"{activity}: {len(keep)} / {preds_views[0].shape[0]} valid")
        if keep.size == 0:
            continue
        jobs = [(act_dir(name, cam), scale)
                for cam in camera_names for name, scale in per_view_roles]
        jobs.append((act_dir(args.gt3d_name), 10.0))
        for d, scale in jobs:
            try:
                write_filtered(os.path.join(d, "poses.npz"),
                               os.path.join(d, f"poses_filtered_{nv}.npz"),
                               keep, scale=scale)
            except (FileNotFoundError, KeyError) as e:
                print(f"[ERROR] {e}", file=sys.stderr)


if __name__ == "__main__":
    main()
