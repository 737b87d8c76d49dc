"""The benchmark's inputs, made from ``--seed`` in numpy alone.

A frozen copy of ``skelsplat_tpu_torch/synthetic.py::synthetic_inputs``
(and of the camera construction it calls), so that the inputs do not move
when the program's copy does: a ring of cameras around a standing volume,
a random skeleton per frame, an initial guess noised from it, and the
skeleton projected into every view as the frame's 2D detections.

Frame ``i`` of stream ``s`` under seed ``seed`` is drawn from its own
``SeedSequence([seed, s, i])``: a run never repeats a frame's inputs, and
any frame can be made again after the window to check its result.
"""

from __future__ import annotations

import math

import numpy as np

ZNEAR = 0.01
ZFAR = 100.0
CAMERA_FIELDS = ("view4", "proj4", "full4", "cam_center", "focal_x",
                 "focal_y", "tan_fovx", "tan_fovy", "width", "height", "uid")

# frame streams of one run: the window's frames, the warm-up's, and the
# draw of the frames whose results are checked
WINDOW, WARM, SAMPLE = 0, 1, 2


def _world2view(R, t):
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return np.float32(Rt)


def _projection_from_K(K, W, H):
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    top = ZNEAR * cy / fy
    bottom = -ZNEAR * (H - cy) / fy
    right = ZNEAR * (W - cx) / fx
    left = -ZNEAR * cx / fx
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2.0 * ZNEAR / (right - left)
    P[1, 1] = 2.0 * ZNEAR / (top - bottom)
    P[0, 2] = -(right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = ZFAR / (ZFAR - ZNEAR)
    P[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return np.float32(P)


def _camera(R, t, K, width, height, uid):
    """One camera's fields (loader convention: ``R`` is stored transposed,
    ``t`` maps world to camera). The focal the renderer sees comes from the
    field-of-view round trip, as the upstream loaders make it."""
    w2v = _world2view(R, t).astype(np.float64)
    proj = _projection_from_K(K, width, height).astype(np.float64)
    c2w = np.linalg.inv(w2v)
    tan_fovx = math.tan(math.atan(width / (2 * K[0, 0])))
    tan_fovy = math.tan(math.atan(height / (2 * K[1, 1])))
    f32 = np.float32
    return dict(view4=w2v.astype(f32), proj4=proj.astype(f32),
                full4=(proj @ w2v).astype(f32),
                cam_center=c2w[:3, 3].astype(f32),
                focal_x=f32(width / (2.0 * tan_fovx)),
                focal_y=f32(height / (2.0 * tan_fovy)),
                tan_fovx=f32(tan_fovx), tan_fovy=f32(tan_fovy),
                width=f32(width), height=f32(height), uid=np.int32(uid))


def rig(config: dict) -> dict:
    """The configuration's ring of cameras: {field: (V, …) numpy}."""
    r = config["rig"]
    V, W, H = config["views"], config["width"], config["height"]
    cams = []
    for v in range(V):
        th = 2 * np.pi * v / V + r["phase_rad"]
        pos = np.array([r["ring_mm"] * np.cos(th), r["ring_mm"] * np.sin(th),
                        r["camera_height_mm"]])
        z = np.array([0, 0, r["target_height_mm"]]) - pos
        z /= np.linalg.norm(z)
        x = np.cross(np.array([0.0, 0.0, -1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        f = r["focal_over_width"] * W
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
        cams.append(_camera(R.T, -R @ pos, K, W, H, v))
    return {k: np.stack([c[k] for c in cams]) for k in CAMERA_FIELDS}


def frames(config: dict, cams: dict, seed: int, stream: int, start: int,
           count: int):
    """Frames ``start`` .. ``start + count`` of a stream: (init (n,N,3),
    gt (n,N,3), p2d (n,V,N,2)) float32."""
    pose = config["pose"]
    N, V, H = config["joints"], config["views"], config["height"]
    init = np.empty((count, N, 3), np.float32)
    gt = np.empty((count, N, 3), np.float32)
    p2d = np.empty((count, V, N, 2), np.float32)
    for k in range(count):
        rng = np.random.default_rng(np.random.SeedSequence(
            [seed % 2 ** 64, stream, start + k]))
        g = rng.normal(0, pose["spread_mm"], (N, 3)).astype(np.float32)
        g[:, 2] += pose["center_height_mm"]
        gt[k] = g
        init[k] = g + rng.normal(0, pose["init_noise_mm"],
                                 (N, 3)).astype(np.float32)
        for v in range(V):
            F = cams["full4"][v]
            w = cams["width"][v]
            hom = g @ F[:3, :3].T + F[:3, 3]
            wh = g @ F[3, :3].T + F[3, 3]
            ndc = hom[:, :2] / (wh[:, None] + 1e-7)
            p2d[k, v, :, 0] = ((ndc[:, 0] + 1) * w - 1) * 0.5
            p2d[k, v, :, 1] = ((ndc[:, 1] + 1) * H - 1) * 0.5
    return init, gt, p2d

