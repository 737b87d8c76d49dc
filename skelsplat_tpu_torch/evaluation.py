"""MPJPE evaluation over saved result clouds (counterpart of
``skelsplat_tpu/evaluation.py``).

Reads ``<output>/point_cloud/iteration_{it}/{scene}.ply`` clouds and the
dataset's 3D GT npz tree, and computes absolute and root-relative MPJPE
and, for H36M, the per-activity breakdown over the 15 ordered activities.
The protocol's rules are kept: S9 {SittingDown 1, Waiting 1, Greeting} is
left out of the absolute MPJPE, the CPN variant's S11/Directions gap is
zero-padded, and the H36M GT is subsampled at frame step 64. The clouds
are read in bulk by the native codec (``native.read_xyz_batch``).

``image_metrics`` renders each scene's final splats on the device and
scores them against the GT heatmaps with SSIM and, given weights, LPIPS.
"""

from __future__ import annotations

import os

import numpy as np
import torch

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
    """(S, N, 3) positions of the clouds at ``paths``: one threaded native
    read, or the numpy reader file by file where the clouds' sizes differ
    or a file did not parse (also where every file failed alike, which
    the JAX package's eval would slice as a count)."""
    from skelsplat_tpu_torch import native

    out, counts = native.read_xyz_batch(paths, max_pts=64)
    n = counts[0]
    if n < 0 or not np.all(counts == n):
        return np.array([ply.read_xyz(p) for p in paths])
    return np.ascontiguousarray(out[:, :n, :])


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


def _scene_plys(run_dir: str) -> dict[str, str]:
    """scene_name → path of its final PLY (the highest iteration dir that
    holds it: an early-stopped scene lives under its stop iteration)."""
    pc = os.path.join(run_dir, "point_cloud")
    out: dict[str, tuple[int, str]] = {}
    if not os.path.isdir(pc):
        return {}
    for d in os.listdir(pc):
        if not d.startswith("iteration_"):
            continue
        it = int(d.split("_")[-1])
        for f in os.listdir(os.path.join(pc, d)):
            if not f.endswith(".ply"):
                continue
            name = f[:-4]
            if name not in out or it > out[name][0]:
                out[name] = (it, os.path.join(pc, d, f))
    return {k: v[1] for k, v in sorted(out.items())}


def _to_rgb(x):
    """(C,H,W) → (3,H,W): the channel sum, min-max normalized, replicated
    to RGB and scaled to [-1, 1] (LPIPS's input convention)."""
    im = torch.sum(x, dim=0)
    lo, hi = torch.min(im), torch.max(im)
    im = (im - lo) / torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    return im[None].expand((3,) + im.shape) * 2 - 1


def lpips_inputs(renders, gt_hm):
    """The (V,3,H,W) LPIPS inputs of a scene's renders and GT heatmaps."""
    return (torch.stack([_to_rgb(r) for r in renders]),
            torch.stack([_to_rgb(t) for t in gt_hm]))


def scene_images(rec, ply_path, scene_type, scaling=3.0,
                 scaling_modifier=1.0, device="cuda"):
    """(renders, GT heatmaps), each (V,C,H,W) on ``device``, of the scene
    ``rec`` with the result cloud at ``ply_path``: all V views render in
    one dense call at the largest width and height of the rig, and the GT
    heatmaps come from the initial covariance, as in training."""
    from skelsplat_tpu_torch.core.gaussians import (PARAM_FIELDS,
                                                    GaussianParams,
                                                    init_params)
    from skelsplat_tpu_torch.data import cameras_io
    from skelsplat_tpu_torch.ops import heatmaps as hm_ops
    from skelsplat_tpu_torch.ops import rasterizer

    g = ply.read_gaussian_ply(ply_path)
    params = GaussianParams(*(
        torch.as_tensor(np.asarray(g[f], np.float32), device=device)
        for f in PARAM_FIELDS))
    cams = cameras_io.build_camera_batch(rec.cameras, device=device)
    W = max(int(c.width) for c in rec.cameras)
    H = max(int(c.height) for c in rec.cameras)
    p0 = init_params(rec.pose_3d, scene_type, scaling, scaling_modifier,
                     device=device)
    spec = hm_ops.heatmap_spec(
        p0.xyz, p0.covariance(),
        torch.as_tensor(np.asarray(rec.poses_2d, np.float32)[..., :2],
                        device=device),
        cams, W, H)
    return (rasterizer.render(params, cams, W, H)["render"],
            hm_ops.eval_heatmaps(spec, W, H))


def image_metrics(loader, output_path, scaling=3.0, scaling_modifier=1.0,
                  lpips_net="vgg", lpips_weights=None, print_fn=print,
                  device="cuda"):
    """Per-scene SSIM (fused SSIM, the mean over views) and, when LPIPS
    weights are given or committed, LPIPS between each scene's rendered
    final splats and its GT heatmaps (``scene_images``), on ``device``.
    For LPIPS each view's C channel maps become one RGB image in [-1, 1]
    (``_to_rgb``), and one scene's V views go through the network as one
    batch.

    Returns {"ssim": mean, "lpips": mean | None, "per_scene": {...}}.
    """
    from skelsplat_tpu_torch import resolve_device
    from skelsplat_tpu_torch.core.gaussians import scene_type_of
    from skelsplat_tpu_torch.ops import lpips as lpips_ops
    from skelsplat_tpu_torch.ops.ssim import fused_ssim

    dev = resolve_device(device)
    plys = _scene_plys(output_path)
    if lpips_weights is None:
        lpips_weights = lpips_ops.default_weights_path(lpips_net)
    lpips_model = (lpips_ops.LPIPS.from_npz(lpips_weights, device=dev)
                   if lpips_weights else None)
    if lpips_model is None:
        print_fn("LPIPS weights not available "
                 "(skelsplat_tpu_torch/ops/lpips_weights/) — reporting SSIM "
                 "only")

    scene_type = scene_type_of(loader.data_root)
    per_scene, ssims, lpipss = {}, [], []
    with torch.no_grad():
        for _, rec in loader:
            path = plys.get(rec.scene_name)
            if path is None:
                continue
            renders, gt_hm = scene_images(rec, path, scene_type, scaling,
                                          scaling_modifier, dev)
            s = float(np.mean([float(fused_ssim(renders[v], gt_hm[v]))
                               for v in range(renders.shape[0])]))
            entry = {"ssim": s}
            ssims.append(s)
            if lpips_model is not None:
                d = float(torch.mean(lpips_model(
                    *lpips_inputs(renders, gt_hm))))
                entry["lpips"] = d
                lpipss.append(d)
            per_scene[rec.scene_name] = entry

    out = {"ssim": float(np.mean(ssims)) if ssims else float("nan"),
           "lpips": float(np.mean(lpipss)) if lpipss else None,
           "per_scene": per_scene}
    print_fn(f"SSIM (render vs GT heatmaps): {out['ssim']:.4f}")
    if out["lpips"] is not None:
        print_fn(f"LPIPS ({lpips_net}): {out['lpips']:.4f}")
    return out
