"""Synthetic H36M-style scenes from a seed, in numpy: a ring of V cameras
around a standing volume, random GT skeletons, noised initial poses and
the GT projected to 2D "detections" (the same construction as the JAX
package's ``__graft_entry__._synthetic_inputs``)."""

from __future__ import annotations

import numpy as np

from skelsplat_tpu_torch.core.cameras import FIELDS, camera_arrays


def synthetic_inputs(n_scenes: int, width: int, height: int, n_views: int = 4,
                     n_joints: int = 17, seed: int = 0, widths=None):
    """(init (S,N,3), gt (S,N,3), p2d (S,V,N,2), cameras) with ``cameras`` a
    dict of stacked numpy Camera fields (leading axis V). ``widths``
    optionally gives each view its own true image width (H36M mixes 1000-
    and 1002-wide cameras); ``width`` is then the grid width, their max."""
    rng = np.random.default_rng(seed)
    widths = [width] * n_views if widths is None else list(widths)
    cams = []
    for v in range(n_views):
        th = 2 * np.pi * v / n_views + 0.4
        pos = np.array([4200 * np.cos(th), 4200 * np.sin(th), 1100.0])
        z = np.array([0, 0, 900.0]) - pos
        z /= np.linalg.norm(z)
        up = np.array([0.0, 0.0, -1.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        t = -R @ pos
        w = widths[v]
        f = 1.15 * w
        K = np.array([[f, 0, w / 2], [0, f, height / 2], [0, 0, 1.0]])
        cams.append(camera_arrays(R.T, t, K, w, height, uid=v))
    cams_b = {k: np.stack([c[k] for c in cams]) for k in FIELDS}

    gt = rng.normal(0, 280, (n_scenes, n_joints, 3)).astype(np.float32)
    gt[..., 2] += 900
    init = gt + rng.normal(0, 40, gt.shape).astype(np.float32)
    p2d = np.zeros((n_scenes, n_views, n_joints, 2), np.float32)
    for v in range(n_views):
        F = cams_b["full4"][v]
        w = widths[v]
        for s in range(n_scenes):
            hom = gt[s] @ F[:3, :3].T + F[:3, 3]
            wh = gt[s] @ F[3, :3].T + F[3, 3]
            ndc = hom[:, :2] / (wh[:, None] + 1e-7)
            p2d[s, v, :, 0] = ((ndc[:, 0] + 1) * w - 1) * 0.5
            p2d[s, v, :, 1] = ((ndc[:, 1] + 1) * height - 1) * 0.5
    return init, gt, p2d, cams_b


def mpjpe(xyz, gt) -> float:
    """Mean per-joint position error (world units, mm here)."""
    return float(np.mean(np.linalg.norm(np.asarray(xyz) - np.asarray(gt),
                                        axis=-1)))
