"""Covariance-confidence analysis of optimized clouds (counterpart of
``skelsplat_tpu/analysis.py``; offline paper-analysis utilities): k-sigma
coverage of the GT joints, error/confidence correlation, and the 2D
anisotropy of each joint's heatmap covariance."""

from __future__ import annotations

import numpy as np
import torch

from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.data import ply
from skelsplat_tpu_torch.ops import heatmaps as hm


def percent_inside_sigmas(means, covs, gt, ks=(1, 2, 3)):
    """Fraction of GT joints whose Mahalanobis distance from the optimized
    Gaussian is ≤ k, per k: means/gt (N,3), covs (N,3,3)."""
    means = np.asarray(means)
    covs = np.asarray(covs)
    gt = np.asarray(gt)
    deltas = gt - means
    d2 = np.einsum("ni,nij,nj->n", deltas, np.linalg.inv(covs), deltas)
    return {k: float(np.sum(d2 <= k ** 2) / means.shape[0]) for k in ks}


def percent_inside_sigmas_per_joint(means, covs, gt, joint_names,
                                    ks=(1, 2, 3)):
    """Per-joint k-sigma coverage over a batch of scenes: means/gt
    (N,J,3), covs (N,J,3,3); returns dict[joint_name][k] = fraction of the
    N scenes whose GT joint lies inside the optimized Gaussian's k-sigma
    ellipsoid."""
    means = np.asarray(means)
    covs = np.asarray(covs)
    gt = np.asarray(gt)
    deltas = gt - means
    d2 = np.einsum("nji,njik,njk->nj", deltas, np.linalg.inv(covs), deltas)
    return {name: {k: float(np.mean(d2[:, j] <= k ** 2)) for k in ks}
            for j, name in enumerate(joint_names)}


def gaussian_cov_from_ply(path):
    """(means (N,3), covs (N,3,3), scales (N,3)) of a result cloud, the
    covariances built from its raw parameters on the CPU."""
    g = ply.read_gaussian_ply(path)
    cov6 = geometry.build_cov3d(torch.exp(torch.as_tensor(g["log_scales"])),
                                torch.as_tensor(g["quats"]))
    covs = geometry.unpack_cov6(cov6).numpy()
    return g["xyz"], covs, np.exp(g["log_scales"])


def error_confidence_correlation(ply_paths, gt_poses):
    """Per-scene (MPJPE, mean sigma) pairs and their Pearson correlation
    (NaN where either is constant or there is one scene)."""
    errors, confidences = [], []
    for path, gt in zip(ply_paths, gt_poses):
        means, covs, _ = gaussian_cov_from_ply(path)
        errors.append(np.linalg.norm(means - np.asarray(gt), axis=1).mean())
        confidences.append(
            np.sqrt(np.trace(covs, axis1=1, axis2=2) / 3).mean())
    errors = np.asarray(errors)
    confidences = np.asarray(confidences)
    if errors.size > 1 and errors.std() > 0 and confidences.std() > 0:
        corr = float(np.corrcoef(errors, confidences)[0, 1])
    else:
        corr = float("nan")
    return {"errors": errors, "confidences": confidences,
            "correlation": corr}


def anisotropy_per_joint(lambdas):
    """Per-joint per-view 2D anisotropy λmax/λmin from a mapping
    {joint_id: [(λ1, λ2), ...views]}."""
    return {joint_id: [float(max(l1, l2) / min(l1, l2))
                       for l1, l2 in view_lambdas]
            for joint_id, view_lambdas in lambdas.items()}


def scene_lambdas(params, cameras, W, H):
    """Per-joint per-view eigenvalues (λ1, λ2) = (σ1², σ2²) of the dilated
    2D heatmap covariance (the GT heatmaps' EWA convention) of one scene's
    optimized Gaussians, all views and joints in one batched evaluation on
    the parameters' device. ``cameras`` is batched over V. Returns
    {joint_id: [(λ1, λ2), ...views]} for ``anisotropy_per_joint``."""
    with torch.no_grad():
        s1, s2 = hm.heatmap_sigmas_for_views(params.xyz, params.covariance(),
                                             cameras)
        l1, l2 = (s1 * s1).cpu().numpy(), (s2 * s2).cpu().numpy()
    return {str(j): [(float(l1[v, j]), float(l2[v, j]))
                     for v in range(l1.shape[0])] for j in range(l1.shape[1])}
