"""Camera / projection / EWA-splatting geometry (counterpart of
``skelsplat_tpu/core/geometry.py``).

Two EWA conventions are kept on purpose, as in the JAX package: the
rasterizer's ``ewa_cov2d_render`` (cov = (J·W) Σ (J·W)ᵀ) and the GT-heatmap
synthesis ``ewa_cov2d_heatmap`` (cov = (W·J)ᵀ Σ (W·J)). MPJPE parity needs
each call site's numerics.

Host-side camera matrices are numpy (float64 → float32). Device-side
functions take float32 tensors. Batching follows broadcasting: a point
tensor has shape (..., 3); a matrix argument has shape (..., 4, 4) and a
per-camera scalar shape (...) whose batch shape broadcasts against the
points' (...). A caller with (V, N, 3) points passes (V, 1, 4, 4) matrices
and (V, 1) scalars. All device math is elementwise f32 in a fixed
operation order; no product runs through a matmul, so TF32 and
FMA-contracting GEMM kernels never touch positions or covariances.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Tile size of the reference rasterizer. The tile-rect culling is part of
# the forward semantics, so the block size is part of the math.
BLOCK_X = 16
BLOCK_Y = 16

# EWA low-pass dilation added to the 2D covariance diagonal.
H_VAR = 0.3
# Near-plane cull threshold.
NEAR_Z = 0.2
# Compositing constants.
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1.0e-4


class _AlphaClamp(torch.autograd.Function):
    """α = min(ALPHA_MAX, x) with the gradient passing straight through the
    clamp: the reference backward chains dL/dG = opa·dL/dα with no clamp
    gate, so a saturated splat still feeds gradient to its screen-space
    quantities. The forward value is exactly the clamp (0.99 rounds to
    itself), which the ``x - (x - clamp(x)).detach()`` idiom does not
    guarantee."""

    @staticmethod
    def forward(ctx, x):
        return torch.clamp(x, max=ALPHA_MAX)

    @staticmethod
    def backward(ctx, grad):
        return grad


def alpha_clamp(x: torch.Tensor) -> torch.Tensor:
    return _AlphaClamp.apply(x)


# ---------------------------------------------------------------------------
# Host-side camera matrix construction (numpy)
# ---------------------------------------------------------------------------

def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP-convention quaternion (w,x,y,z) to rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix to COLMAP (w,x,y,z) quaternion, w ≥ 0."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(R).as_quat()  # (x, y, z, w)
    qvec = np.array([q[3], q[0], q[1], q[2]])
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def world2view(R: np.ndarray, t: np.ndarray,
               translate: np.ndarray | None = None, scale: float = 1.0) -> np.ndarray:
    """World→camera 4×4 matrix. ``R`` is stored transposed by the dataset
    loaders, so the rotation block is ``R.T``."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + translate) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def projection_from_K(znear: float, zfar: float, K: np.ndarray,
                      W: int, H: int) -> np.ndarray:
    """OpenGL-style frustum from pinhole intrinsics with principal point,
    including the reference's sign convention on P[0,2]."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    top = znear * cy / fy
    bottom = -znear * (H - cy) / fy
    right = znear * (W - cx) / fx
    left = -znear * cx / fx

    P = np.zeros((4, 4), dtype=np.float64)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = -(right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return np.float32(P)


def projection_symmetric(znear: float, zfar: float, fovX: float, fovY: float) -> np.ndarray:
    """Symmetric-frustum projection."""
    tanY = math.tan(fovY / 2)
    tanX = math.tan(fovX / 2)
    top, right = tanY * znear, tanX * znear
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return np.float32(P)


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


# ---------------------------------------------------------------------------
# Device-side math (torch, float32)
# ---------------------------------------------------------------------------

def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (w,x,y,z), L2-normalized here, → (..., 3, 3)."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    q = q / norm
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def build_cov3d(scales: torch.Tensor, quats: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """(..., 3) activated scales + (..., 4) quaternions → (..., 6) packed
    covariance [xx, xy, xz, yy, yz, zz], Σ = L·Lᵀ with L = R·diag(s), in
    closed form."""
    R = quat_to_rotmat(quats)
    s = scale_modifier * scales
    L = R * s[..., None, :]
    r0, r1, r2 = L[..., 0, :], L[..., 1, :], L[..., 2, :]
    return torch.stack(
        [_dot3(r0, r0), _dot3(r0, r1), _dot3(r0, r2),
         _dot3(r1, r1), _dot3(r1, r2), _dot3(r2, r2)],
        dim=-1,
    )


def unpack_cov6(cov6: torch.Tensor) -> torch.Tensor:
    """(..., 6) packed covariance → (..., 3, 3) symmetric matrix."""
    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))
    rows = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], dim=-1)
    return rows.reshape(cov6.shape[:-1] + (3, 3))


def _affine_rows(p: torch.Tensor, M: torch.Tensor, rows: int) -> torch.Tensor:
    """Points (..., 3) through the first ``rows`` rows of (..., 4, 4)
    matrices: out[j] = Σ_k p[k]·M[j,k] + M[j,3], elementwise."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack(
        [x * M[..., j, 0] + y * M[..., j, 1] + z * M[..., j, 2] + M[..., j, 3]
         for j in range(rows)], dim=-1)


def view_transform_point(p: torch.Tensor, view4: torch.Tensor) -> torch.Tensor:
    """World point(s) (..., 3) through a world→view matrix → camera coords."""
    return _affine_rows(p, view4, 3)


def project_point_full(p: torch.Tensor, full4: torch.Tensor) -> torch.Tensor:
    """World point(s) through the full projection → NDC, with the
    reference's 1e-7-regularized perspective divide."""
    hom = _affine_rows(p, full4, 4)
    w = 1.0 / (hom[..., 3:4] + 1.0e-7)
    return hom[..., :3] * w


def ndc2pix(v: torch.Tensor, size) -> torch.Tensor:
    """NDC → pixel coordinate."""
    return ((v + 1.0) * size - 1.0) * 0.5


def _clamped_view_point(t: torch.Tensor, tan_fovx, tan_fovy) -> torch.Tensor:
    """The 1.3·tan(fov/2) frustum clamp of the view-space point before the
    projective Jacobian."""
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tz = t[..., 2]
    tx = torch.clamp(t[..., 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[..., 1] / tz, -limy, limy) * tz
    return torch.stack([tx, ty, tz], dim=-1)


def _proj_jacobian(t: torch.Tensor, focal_x, focal_y) -> torch.Tensor:
    """Row-form projective Jacobian J (3×3, last row zero) at t."""
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    z = torch.zeros_like(tz)
    J = torch.stack(
        [
            focal_x / tz, z, -(focal_x * tx) / (tz * tz),
            z, focal_y / tz, -(focal_y * ty) / (tz * tz),
            z, z, z,
        ],
        dim=-1,
    )
    return J.reshape(t.shape[:-1] + (3, 3))


def ewa_cov2d_render(mean3d, cov6, view4, focal_x, focal_y,
                     tan_fovx, tan_fovy) -> torch.Tensor:
    """2D screen-space covariance, rasterizer convention: cov2d = B Σ Bᵀ
    with B = J·W2V[:3,:3], expanded in closed form. Returns (..., 3) =
    (cov_xx, cov_xy, cov_yy) without the +0.3 dilation."""
    t = view_transform_point(mean3d, view4)
    t = _clamped_view_point(t, tan_fovx, tan_fovy)
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    W = view4[..., :3, :3]
    s0, s2 = focal_x / tz, focal_y / tz
    s1 = -(focal_x * tx) / (tz * tz)
    s3 = -(focal_y * ty) / (tz * tz)
    b0 = [s0 * W[..., 0, k] + s1 * W[..., 2, k] for k in range(3)]
    b1 = [s2 * W[..., 1, k] + s3 * W[..., 2, k] for k in range(3)]
    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))

    def quad(u, v):
        return (u[0] * v[0] * xx + u[1] * v[1] * yy + u[2] * v[2] * zz
                + (u[0] * v[1] + u[1] * v[0]) * xy
                + (u[0] * v[2] + u[2] * v[0]) * xz
                + (u[1] * v[2] + u[2] * v[1]) * yz)

    return torch.stack([quad(b0, b0), quad(b0, b1), quad(b1, b1)], dim=-1)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3×3 product, summed over k = 0, 1, 2 in that order."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def ewa_cov2d_heatmap(mean3d, cov6, view4, focal_x, focal_y,
                      tan_fovx, tan_fovy) -> torch.Tensor:
    """2D covariance, GT-heatmap convention: cov = (W·J)ᵀ Σ (W·J), entries
    (0,0), (0,1), (1,1), without the +0.3 dilation."""
    t = view_transform_point(mean3d, view4)
    t = _clamped_view_point(t, tan_fovx, tan_fovy)
    J = _proj_jacobian(t, focal_x, focal_y)
    A = _mm3(view4[..., :3, :3], J)
    Vrk = unpack_cov6(cov6)
    cov = _mm3(_mm3(A.transpose(-1, -2), Vrk.transpose(-1, -2)), A)
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]], dim=-1)


def cov2d_to_conic_radius(cov2d: torch.Tensor):
    """Dilated 2D covariance → (conic (..., 3), radius (...), det (...)):
    +0.3 on the diagonal, conic = inverse, radius = ceil(3·√λmax) with the
    mid²−det floor of 0.1."""
    cx = cov2d[..., 0] + H_VAR
    cy = cov2d[..., 1]
    cz = cov2d[..., 2] + H_VAR
    det = cx * cz - cy * cy
    det_inv = torch.where(det != 0.0, 1.0 / det, torch.zeros_like(det))
    conic = torch.stack([cz * det_inv, -cy * det_inv, cx * det_inv], dim=-1)
    mid = 0.5 * (cx + cz)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    lambda2 = mid - disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, lambda2)))
    return conic, radius, det


def heatmap_sigmas(cov2d: torch.Tensor):
    """Dilated 2D covariance → (σ1, σ2) = (√λ1, √λ2), the axis-aligned blur
    sigmas of the GT heatmaps (σ1 blurs rows, σ2 columns)."""
    cx = cov2d[..., 0] + H_VAR
    cy = cov2d[..., 1]
    cz = cov2d[..., 2] + H_VAR
    det = cx * cz - cy * cy
    mid = 0.5 * (cx + cz)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    return torch.sqrt(mid + disc), torch.sqrt(mid - disc)


def tile_rect(point_image: torch.Tensor, radius: torch.Tensor, W: int, H: int):
    """Tile-space bounding rect of a splat: (rect_min_xy, rect_max_xy) int32
    in tile units; C's truncating division, then the clamp."""
    grid_x = (W + BLOCK_X - 1) // BLOCK_X
    grid_y = (H + BLOCK_Y - 1) // BLOCK_Y
    px, py = point_image[..., 0], point_image[..., 1]

    def trunc_div(a, b):
        return torch.trunc(a / b).to(torch.int32)

    min_x = torch.clamp(trunc_div(px - radius, BLOCK_X), 0, grid_x)
    min_y = torch.clamp(trunc_div(py - radius, BLOCK_Y), 0, grid_y)
    max_x = torch.clamp(trunc_div(px + radius + BLOCK_X - 1, BLOCK_X), 0, grid_x)
    max_y = torch.clamp(trunc_div(py + radius + BLOCK_Y - 1, BLOCK_Y), 0, grid_y)
    return torch.stack([min_x, min_y], dim=-1), torch.stack([max_x, max_y], dim=-1)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


def strip_symmetric(sym: torch.Tensor) -> torch.Tensor:
    """(…,3,3) symmetric matrix → (…,6) packed upper triangle."""
    return torch.stack(
        [sym[..., 0, 0], sym[..., 0, 1], sym[..., 0, 2],
         sym[..., 1, 1], sym[..., 1, 2], sym[..., 2, 2]], dim=-1)


strip_lowerdiag = strip_symmetric


def build_scaling_rotation(s: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """L = R·diag(s)."""
    return quat_to_rotmat(r) * s[..., None, :]


def geom_transform_points(points: torch.Tensor,
                          transf_matrix: torch.Tensor) -> torch.Tensor:
    """Homogeneous point transform, row vectors times the (transposed)
    matrix, with a 1e-7-regularized divide by w."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    out = torch.matmul(torch.cat([points, ones], dim=-1), transf_matrix)
    return out[..., :3] / (out[..., 3:] + 1e-7)


def expon_lr(step: torch.Tensor, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1000000) -> torch.Tensor:
    """Log-linear LR decay with optional sine warm-delay, on a float32
    ``step`` tensor (no host sync)."""
    step = step.to(torch.float32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    # f32 logs of the endpoints, made on the device: torch.tensor(x,
    # device="cuda") would copy from the host and wait for the stream
    log_i = torch.log(torch.full((), lr_init, dtype=torch.float32,
                                 device=step.device))
    log_f = torch.log(torch.full((), lr_final, dtype=torch.float32,
                                 device=step.device))
    log_lerp = torch.exp(log_i * (1 - t) + log_f * t)
    return torch.where(step < 0, torch.zeros_like(step), delay_rate * log_lerp)
