"""Visualization helpers (counterpart of ``skelsplat_tpu/viz.py``, itself
the reference's utils/viz_utils.py: analysis-only, never imported by the
entry points). Matplotlib, imported at first use (``_plt``), numpy-in:
tensors are copied to the host first (``_np``).

Function-for-function inventory vs the reference module:

=========================  ==============================================
utils/viz_utils.py         here
=========================  ==============================================
show_joints_htmp     :8    show_joints_htmp
show_single_htmp     :27   show_single_htmp
plot_rendering       :38   plot_rendering
save_rendering       :60   save_rendering
plot_gaussians       :81   plot_gaussian_cloud (multi-set scatter; the
                           commented-out covariance wireframe lives in
                           plot_3d_gaussians)
plot_3d_pose         :103  plot_3d_pose (joints only → skeleton=())
plot_3d_pose_2       :134  plot_3d_pose (bone segments, H36M_SKELETON)
plot_3d_pose_3       :202  plot_3d_pose_grounded (y-up swap + floor
                           grounding, COCO19_SKELETON for panoptic)
plot_2d_pose         :262  plot_2d_pose
plot_3d_gaussians    :283  plot_3d_gaussians
=========================  ==============================================

All functions take ``out_path`` (PNG) instead of the reference's
interactive ``plt.show()`` so they work headless.
"""

from __future__ import annotations

import os

import numpy as np

H36M_SKELETON = [
    (0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (0, 7), (7, 8),
    (8, 9), (9, 10), (8, 11), (11, 12), (12, 13), (8, 14), (14, 15),
    (15, 16),
]

# CMU-Panoptic COCO19 bone list (viz_utils.py:202-224)
COCO19_SKELETON = [
    (0, 1), (0, 3), (3, 4), (4, 5), (0, 9), (9, 10), (10, 11),
    (2, 6), (6, 7), (7, 8), (2, 12), (12, 13), (13, 14),
    (1, 15), (15, 17), (1, 16), (16, 18), (2, 0),
]


def _np(x):
    """A host numpy array of an array or a tensor on any device."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def show_joints_htmp(htmp, out_path=None):
    """Grid of per-joint heatmap channels (viz_utils.show_joints_htmp)."""
    plt = _plt()
    htmp = _np(htmp)
    n = htmp.shape[0]
    cols = 6
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    for j in range(rows * cols):
        ax = axes.flat[j]
        if j < n:
            ax.imshow(htmp[j])
            ax.set_title(f"joint {j}", fontsize=7)
        ax.axis("off")
    return _out(fig, out_path)


def show_single_htmp(htmp, out_path=None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(_np(htmp))
    ax.axis("off")
    return _out(fig, out_path)


def plot_rendering(render, gt_image, out_path=None):
    """Side-by-side channel-summed render vs GT (viz_utils.plot_rendering)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    for ax, im, t in zip(axes, [render, gt_image], ["render", "gt"]):
        im = _np(im)
        if im.ndim == 3:
            im = im.sum(axis=0)
        ax.imshow(im)
        ax.set_title(t)
        ax.axis("off")
    return _out(fig, out_path)


def save_rendering(render, gt_image, out_dir, image_name, iteration):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{image_name}_{iteration}.png")
    plot_rendering(render, gt_image, out_path=path)
    return path


def plot_2d_pose(gt_pose, pred_pose=None, skeleton=H36M_SKELETON,
                 out_path=None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 8))
    for pose, color, label in [(gt_pose, "g", "GT"),
                               (pred_pose, "r", "pred")]:
        if pose is None:
            continue
        pose = _np(pose)
        for a, b in skeleton:
            ax.plot([pose[a, 0], pose[b, 0]], [pose[a, 1], pose[b, 1]],
                    color=color, alpha=0.7, marker="o", markersize=3)
        ax.scatter(pose[:, 0], pose[:, 1], color=color, label=label, s=14)
    ax.invert_yaxis()
    ax.axis("equal")
    ax.legend()
    return _out(fig, out_path)


def plot_3d_pose(gt_pose, pred_pose=None, skeleton=H36M_SKELETON,
                 out_path=None):
    plt = _plt()
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    for pose, color, label in [(gt_pose, "g", "GT"),
                               (pred_pose, "r", "pred")]:
        if pose is None:
            continue
        pose = _np(pose)
        for a, b in skeleton:
            ax.plot([pose[a, 0], pose[b, 0]], [pose[a, 1], pose[b, 1]],
                    [pose[a, 2], pose[b, 2]], color=color, alpha=0.7)
        ax.scatter(pose[:, 0], pose[:, 1], pose[:, 2], color=color,
                   label=label, s=14)
    ax.legend()
    return _out(fig, out_path)


def plot_3d_gaussians(means, scaling, opacity=None, color="blue", n_std=2,
                      out_path=None):
    """Ellipsoid wireframes at n_std·scale (viz_utils.plot_3d_gaussians)."""
    plt = _plt()
    means = _np(means)
    scaling = _np(scaling)
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    u = np.linspace(0, 2 * np.pi, 16)
    v = np.linspace(0, np.pi, 8)
    sx = np.outer(np.cos(u), np.sin(v))
    sy = np.outer(np.sin(u), np.sin(v))
    sz = np.outer(np.ones_like(u), np.cos(v))
    for m, s in zip(means, scaling):
        ax.plot_wireframe(m[0] + n_std * s[0] * sx,
                          m[1] + n_std * s[1] * sy,
                          m[2] + n_std * s[2] * sz,
                          color=color, alpha=0.2, linewidth=0.5)
    ax.scatter(means[:, 0], means[:, 1], means[:, 2], color=color, s=10)
    return _out(fig, out_path)


def plot_gaussian_cloud(xyz_sets, lim=1000.0, out_path=None):
    """Scatter of one or more (N, 3) point sets, viridis-colored per set
    (viz_utils.plot_gaussians — its per-view optimized-splat comparison)."""
    plt = _plt()
    xyz_sets = _np(xyz_sets)
    if xyz_sets.ndim == 2:
        xyz_sets = xyz_sets[None]
    colors = plt.cm.viridis(np.linspace(0, 1, xyz_sets.shape[0]))
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    for pts, c in zip(xyz_sets, colors):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], color=c, marker="o",
                   s=12)
    for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        setter([-lim, lim])
    return _out(fig, out_path)


def plot_3d_pose_grounded(gt_pose, pred_pose=None,
                          skeleton=COCO19_SKELETON, out_path=None):
    """Publication-style pose plot (viz_utils.plot_3d_pose_3): appends a
    pelvis joint for <=18-joint poses (midpoint of joints 8 and 11,
    viz_utils.py:232-234), swaps to the (x, z, y) frame and grounds the
    minimum of column 1 — the reference's vertical axis after the swap
    (viz_utils.py:210-215) — then hides the axes chrome."""
    plt = _plt()
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")

    def prep(pose):
        pose = _np(pose)
        if pose.shape[0] <= 18:
            pelvis = (pose[8] + pose[11]) / 2
            pose = np.vstack([pose, pelvis])
        pose = pose[:, [0, 2, 1]]                   # (x, z, y)
        return pose - [0.0, pose[:, 1].min(), 0.0]  # ground column 1

    for pose, color, label in [(gt_pose, "green", "GT"),
                               (pred_pose, "royalblue", "pred")]:
        if pose is None:
            continue
        pose = prep(pose)
        for a, b in skeleton:
            ax.plot([pose[a, 0], pose[b, 0]], [pose[a, 1], pose[b, 1]],
                    [pose[a, 2], pose[b, 2]], color=color)
        ax.scatter(pose[:, 0], pose[:, 1], pose[:, 2], color=color,
                   label=label, s=14)
    ax.grid(False)
    ax.set_xticks([]), ax.set_yticks([]), ax.set_zticks([])
    ax.legend()
    return _out(fig, out_path)


def _out(fig, out_path):
    if out_path:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        fig.savefig(out_path, dpi=90, bbox_inches="tight")
        import matplotlib.pyplot as plt
        plt.close(fig)
        return out_path
    return fig
