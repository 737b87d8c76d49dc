"""MPJPE evaluation over saved result clouds (counterpart of
``skelsplat_tpu/evaluation.py``).

Reads ``<output>/point_cloud/iteration_{it}/{scene}.ply`` clouds and the
dataset's 3D GT npz tree, and computes absolute and root-relative MPJPE
and, for H36M, the per-activity breakdown over the 15 ordered activities.
The protocol's rules are kept: S9 {SittingDown 1, Waiting 1, Greeting} is
left out of the absolute MPJPE, the CPN variant's S11/Directions gap is
zero-padded, and the H36M GT is subsampled at frame step 64. The
image-space metrics (SSIM/LPIPS) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os

import numpy as np

from skelsplat_tpu_torch.data import ply

H36M_ACTIVITIES = (
    "Directions Discussion Eating Greeting Phoning Posing Purchases "
    "Sitting SittingDown Smoking Photo Waiting Walking WalkDog WalkTogether"
).split()

S9_BAD = ["SittingDown 1", "Waiting 1", "Greeting"]


def align_pred_cpn(pred_coords, gt_coords, image_relpaths):
    """Zero-pad the predictions at the S11/Directions gap (CPN variant)."""
    start_poses = 0
    count = 0
    for i, path in enumerate(image_relpaths):
        if "S11" in path and "Directions." in path:
            start_poses = i
            count += 1
    insert = np.zeros((count, 17, 3))
    return np.vstack((pred_coords[:start_poses], insert,
                      pred_coords[start_poses:]))


def _bulk_read(paths):
    """(S, N, 3) positions of the clouds at ``paths``, read one by one
    with the numpy reader (the JAX package's threaded native codec gives
    the same arrays; its port is ROADMAP.md §1 item 10)."""
    return np.array([ply.read_xyz(p) for p in paths])


def get_pred_coords_h36m(ply_dir, sorted_entries, absolute=False, cpn=False):
    """H36M predictions in entry order, and each one's activity."""
    activities, paths = [], []
    for subject, activity, frame in sorted_entries:
        if absolute and subject == "S9" and activity in S9_BAD:
            continue
        paths.append(f"{ply_dir}/{subject}_{activity}_{frame}")
        activities.append(activity.split(" ")[0])
    return _bulk_read(paths), np.array(activities)


def get_pred_coords(ply_dir, sorted_entries, absolute=False):
    """Panoptic / Occlusion-Person predictions in entry order."""
    return _bulk_read([f"{ply_dir}/{subject}_{activity}_{frame}"
                       for subject, activity, frame in sorted_entries])


def get_gt_poses_h36m(gt_path, absolute=False, cpn=False, frame_step=64):
    """The H36M 3D GT, subject by subject, subsampled at ``frame_step``."""
    gt_poses = []
    for subject in sorted(os.listdir(gt_path)):
        if not subject.startswith("S"):
            continue
        for activity in sorted(os.listdir(f"{gt_path}/{subject}")):
            if absolute and subject == "S9" and activity in S9_BAD:
                continue
            if cpn and subject == "S11" and activity == "Directions":
                continue
            gt_3d = np.load(f"{gt_path}/{subject}/{activity}/poses.npz")["poses"]
            gt_poses.append(gt_3d[::frame_step])
    return np.concatenate(gt_poses, axis=0)


def get_gt_poses(gt_path, absolute=False, dataset="panoptic", frame_step=1,
                 nviews=4):
    """The Panoptic / Occlusion-Person 3D GT."""
    gt_poses = []
    for subject in sorted(os.listdir(gt_path)):
        if not subject.startswith("S"):
            continue
        for activity in sorted(os.listdir(f"{gt_path}/{subject}")):
            if dataset == "panoptic":
                gt_3d = np.load(
                    f"{gt_path}/{subject}/{activity}/poses_filtered_{nviews}.npz",
                    allow_pickle=True)["poses"]
            else:
                gt_3d = np.load(f"{gt_path}/{subject}/{activity}/poses.npz",
                                allow_pickle=True)["poses3d"]
            gt_poses.append(gt_3d[::frame_step])
    return np.concatenate(gt_poses, axis=0)


def _entries(ply_dir, gt_path):
    """Sorted (subject, activity, frame) parts of the cloud names."""
    entries = os.listdir(ply_dir)
    if "panoptic" in gt_path:
        name_parts = [[e.split("_")[0], e.split("_")[1] + "_" + e.split("_")[2],
                       e.split("_")[-1]] for e in entries]
    elif "occlusion-person" in gt_path:
        name_parts = [[e.split("_")[0], e.split("_")[1], e.split("_")[-1]]
                      for e in entries]
    else:
        name_parts = [e.split("_") for e in entries]
    return sorted(name_parts)


def evaluate(gt_path, output_path, iterations, start_id, end_id, cpn=False,
             nviews=4, print_fn=print):
    """Prints and returns {iteration: {absolute, relative[,
    per_activity_abs, per_activity_rel]}} in mm."""
    results = {}
    for it in iterations:
        print_fn(f"Results for {it} iterations \n")
        ply_dir = f"{output_path}/point_cloud/iteration_{it}"
        sorted_entries = _entries(ply_dir, gt_path)
        res = {}

        if "h36m" in gt_path:
            # absolute
            gt_coords = get_gt_poses_h36m(gt_path, True, cpn, frame_step=64)
            pred_coords, activities = get_pred_coords_h36m(
                ply_dir, sorted_entries, True, cpn)
            e_id = min(end_id, pred_coords.shape[0]) if end_id else pred_coords.shape[0]
            print_fn(f"Evaluating scenes from {start_id} to {e_id}")
            abs_error = np.linalg.norm(
                gt_coords[start_id:e_id] - pred_coords[start_id:e_id], axis=-1)
            res["absolute"] = float(np.mean(abs_error))
            print_fn(f"Absolute MPJPE:  {np.round(res['absolute'], 2)}")
            act = activities[start_id:e_id]
            res["per_activity_abs"] = {
                a: float(np.mean(abs_error[act == a]))
                for a in H36M_ACTIVITIES}
            print_fn(str(np.round([res["per_activity_abs"][a]
                                   for a in H36M_ACTIVITIES], 2)))
            # relative
            gt_coords = get_gt_poses_h36m(gt_path, False, cpn, frame_step=64)
            pred_coords, activities = get_pred_coords_h36m(
                ply_dir, sorted_entries, False, cpn)
            gt_coords = gt_coords - gt_coords[:, 0, None]
            pred_coords = pred_coords - pred_coords[:, 0, None]
            e_id = min(end_id, pred_coords.shape[0]) if end_id else pred_coords.shape[0]
            rel_error = np.linalg.norm(
                gt_coords[start_id:e_id] - pred_coords[start_id:e_id], axis=-1)
            res["relative"] = float(np.mean(rel_error))
            print_fn(f"Relative MPJPE:  {np.round(res['relative'], 2)}")
            act = activities[start_id:e_id]
            res["per_activity_rel"] = {
                a: float(np.mean(rel_error[act == a]))
                for a in H36M_ACTIVITIES}
            print_fn(str(np.round([res["per_activity_rel"][a]
                                   for a in H36M_ACTIVITIES], 2)))
        else:
            dataset = "panoptic" if "panoptic" in gt_path else "occlusion-person"
            gt_coords = get_gt_poses(gt_path, True, dataset, frame_step=1,
                                     nviews=nviews)
            pred_coords = get_pred_coords(ply_dir, sorted_entries, True)
            e_id = min(end_id, pred_coords.shape[0]) if end_id and end_id > 0 \
                else pred_coords.shape[0]
            print_fn(f"Evaluating scenes from {start_id} to {e_id}")
            abs_error = np.linalg.norm(
                gt_coords[start_id:e_id] - pred_coords[start_id:e_id], axis=-1)
            res["absolute"] = float(np.mean(abs_error))
            print_fn(f"Absolute MPJPE:  {np.round(res['absolute'], 2)}")
            gt_rel = gt_coords - gt_coords[:, 0, None]
            pred_rel = pred_coords - pred_coords[:, 0, None]
            rel_error = np.linalg.norm(
                gt_rel[start_id:e_id] - pred_rel[start_id:e_id], axis=-1)
            res["relative"] = float(np.mean(rel_error))
            print_fn(f"Relative MPJPE:  {np.round(res['relative'], 2)}")
        results[it] = res
    return results
