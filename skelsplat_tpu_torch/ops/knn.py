"""Mean squared distance to the nearest neighbours (counterpart of
``skelsplat_tpu/ops/knn.py``, simple-knn's ``distCUDA2``).

``knn_mean_sq_dist`` is the exact search, tiled: the squared distances to
one tile of points at a time (‖a‖² + ‖b‖² − 2a·bᵀ, one matmul in full f32)
merge into a running best k, so memory is O(N·tile), not O(N²). A point is
never its own neighbour (excluded by index, so a duplicate point counts at
distance 0); with fewer than k other points the missing distances are
+inf. ``knn_scale_init`` is the upstream-3DGS scale initialization.
"""

from __future__ import annotations

import torch


def knn_mean_sq_dist(points, k: int = 3, tile: int = 2048):
    """(N,3) → (N,) mean of the squared distances to the k nearest
    neighbours (self excluded)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    sq = torch.sum(pts * pts, dim=-1)
    rows = torch.arange(n, device=pts.device)
    best = torch.full((n, k), float("inf"), device=pts.device)
    for t0 in range(0, n, tile):
        blk, blk_sq = pts[t0:t0 + tile], sq[t0:t0 + tile]
        d2 = torch.clamp_min(sq[:, None] + blk_sq[None, :]
                             - 2.0 * (pts @ blk.T), 0.0)
        cols = torch.arange(t0, t0 + blk.shape[0], device=pts.device)
        d2 = torch.where(cols[None, :] == rows[:, None], float("inf"), d2)
        best = torch.topk(torch.cat([best, d2], dim=1), k, dim=1,
                          largest=False).values
    return torch.mean(best, dim=1)


def dist2_mean3nn(points):
    """simple-knn's ``distCUDA2``: the mean squared 3-NN distance."""
    return knn_mean_sq_dist(points, k=3)


def knn_scale_init(points, floor: float = 1e-7):
    """(N,3) log-scales log(√max(distCUDA2, floor)), the same on all three
    axes."""
    d2 = torch.clamp_min(dist2_mean3nn(points), floor)
    return torch.log(torch.sqrt(d2))[:, None].repeat(1, 3)
