"""Per-view gradient consistency and confidence weighting (counterpart of
``skelsplat_tpu/ops/similarity.py``).

Every function takes a stack of per-view gradients (…,V,N,D), or a
similarity or error matrix made from one, with any leading scene axes: the
batched trainer fuses each scene's (V,N,3) stack on its own. The einsums
run in float32 (TF32 stays off: ``ops/cuda_raster.py`` turns it off and
sets matmul precision "highest" when imported).

``confidence_weighted_mean`` is the trainer's
``training.view_fusion=confidence_weighted`` (off by default: the plain
mean over views is the reference's fusion).
"""

from __future__ import annotations

import math

import torch


def _eye(v: int, device) -> torch.Tensor:
    return torch.eye(v, dtype=torch.bool, device=device)


def _by_joint(gradients):
    """(…,V,N,D) → (…,N,V,D)."""
    return gradients.transpose(-3, -2)


def pairwise_cosine_similarity(gradients, eps: float = 1e-8):
    """(…,V,N,D) per-view gradients → (…,N,V,V) cosine similarity between
    views per joint, diagonal forced to 1. Each view's gradient is
    normalized by its own norm + eps before the dot products."""
    g = _by_joint(gradients)
    gn = g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + eps)
    sim = torch.einsum("...vc,...wc->...vw", gn, gn)
    return torch.where(_eye(sim.shape[-1], sim.device), 1.0, sim)


def pairwise_cosine_norm_similarity(gradients, w1: float = 0.2,
                                    w2: float = 0.8, eps: float = 1e-8):
    """(…,V,N,D) → (…,N,V,V) blended similarity: per joint, the gradients
    are divided by the SUM of the per-view norms (when it is positive),
    then each pair scores

        w1 · cos(g1, g2) − w2 · |‖g1‖−‖g2‖| / (max(‖g1‖, ‖g2‖) + eps),

    agreement in direction minus disagreement in magnitude. Diagonal
    forced to 1."""
    g = _by_joint(gradients)
    total = torch.sum(torch.linalg.vector_norm(g, dim=-1), dim=-1)  # (…,N)
    safe = torch.where(total == 0, torch.ones_like(total), total)
    g = torch.where(total[..., None, None] > 0, g / safe[..., None, None], g)

    n = torch.linalg.vector_norm(g, dim=-1)                          # (…,N,V)
    dots = torch.einsum("...vc,...wc->...vw", g, g)
    cos = dots / (n[..., :, None] * n[..., None, :] + eps)
    rel = (torch.abs(n[..., :, None] - n[..., None, :])
           / (torch.maximum(n[..., :, None], n[..., None, :]) + eps))
    score = w1 * cos - w2 * rel
    return torch.where(_eye(score.shape[-1], score.device), 1.0, score)


def identify_consistent_views(pairwise_similarity, threshold: float = 0.5):
    """(…,N,V,V) similarity → (…,N,V) bool: a view is consistent when it
    agrees (similarity ≥ threshold) with at least 2 OTHER views (the −1
    removes the diagonal's self-match)."""
    agree = torch.sum(pairwise_similarity >= threshold, dim=-1) - 1
    return agree >= 2


def weight_function(s):
    """Piecewise confidence map: linear 0.8·(s+1) on [−1, 0), logarithmic
    0.54·log₃(s+2) + 0.46 on [0, 1], zero outside [−1, 1]."""
    s = torch.as_tensor(s)
    log_part = 0.54 * (torch.log(s + 2.0) / math.log(3.0)) + 0.46
    lin_part = 0.8 * (s + 1.0)
    out = torch.zeros_like(s)
    out = torch.where((s >= -1) & (s < 0), lin_part, out)
    return torch.where((s >= 0) & (s <= 1), log_part, out)


def compute_scaling_weights(similarity_matrix, n_other: int | None = None):
    """(…,N,V,V) similarity → (…,V,N) per-view confidence weights: the
    mean off-diagonal similarity of each view through
    ``weight_function``. ``n_other`` defaults to V−1 (the reference's
    hard-coded 3 on its 4-camera rig); pass 3 for the literal reference on
    any V."""
    v = similarity_matrix.shape[-1]
    if n_other is None:
        n_other = max(v - 1, 1)
    diag = torch.diagonal(similarity_matrix, dim1=-2, dim2=-1)      # (…,N,V)
    sims = (torch.sum(similarity_matrix, dim=-1) - diag) / n_other
    return weight_function(sims).transpose(-1, -2)


def select_views(error_matrix, threshold: float = 2.5, min_views: int = 4):
    """(…,V,J) per-view per-joint error → the view selection, as the
    triple

    * ``selected_views`` (…,V,J) bool: error ≤ threshold, with columns of
      fewer than ``min_views`` hits filled with that joint's
      ``min_views`` lowest-error views;
    * ``best_views`` (…,min_views): views ranked by how many joints
      selected them, ties to the lower view index;
    * ``final_matrix`` (…,V,J) bool: the best views' rows set True.
    """
    err = torch.as_tensor(error_matrix)
    selected = err <= threshold
    # rank of each view within its joint column by ascending error
    order = torch.argsort(err, dim=-2, stable=True)
    ranks = torch.argsort(order, dim=-2, stable=True)
    needs_fill = torch.sum(selected, dim=-2) < min_views            # (…,J)
    selected = selected | (needs_fill[..., None, :] & (ranks < min_views))

    view_scores = torch.sum(selected, dim=-1)                       # (…,V)
    best_views = torch.argsort(-view_scores, dim=-1,
                               stable=True)[..., :min_views]
    rows = torch.zeros(view_scores.shape, dtype=torch.bool,
                       device=err.device).scatter(-1, best_views, True)
    return selected, best_views, rows[..., None].expand(selected.shape)


def confidence_weighted_mean(gradients, w1: float = 0.2, w2: float = 0.8,
                             eps: float = 1e-8):
    """(…,V,N,D) per-view gradients → (…,N,D): the mean over views
    weighted by each view's confidence (blended similarity →
    ``compute_scaling_weights``), normalized by the weights' total, so
    equal weights give the plain mean; a joint whose weights are all zero
    (every view maximally inconsistent) takes the plain mean."""
    sim = pairwise_cosine_norm_similarity(gradients, w1, w2, eps)
    w = compute_scaling_weights(sim)                                # (…,V,N)
    tot = torch.sum(w, dim=-2)                                      # (…,N)
    safe = torch.where(tot == 0, torch.ones_like(tot), tot)
    weighted = torch.einsum("...vn,...vnd->...nd", w,
                            gradients) / safe[..., None]
    mean = torch.mean(gradients, dim=-3)
    return torch.where((tot == 0)[..., None], mean, weighted)


# --- conveniences beyond the reference ---------------------------------------

def view_consistency_scores(grads, eps: float = 1e-8):
    """(…,V,N,3) → (…,N,V): the mean cosine similarity of each view's
    gradient to the other views' (diagonal excluded)."""
    sim = pairwise_cosine_similarity(grads, eps)                    # (…,N,V,V)
    v = sim.shape[-1]
    off = sim - torch.eye(v, dtype=sim.dtype, device=sim.device)
    return torch.sum(off, dim=-1) / max(v - 1, 1)


def select_consistent_views(grads, k: int, eps: float = 1e-8):
    """(…,V,N,3) → (…,N,k) indices of the k most agreeing views per
    joint."""
    scores = view_consistency_scores(grads, eps)                    # (…,N,V)
    return torch.argsort(-scores, dim=-1, stable=True)[..., :k]
