"""Differentiable skeletal Gaussian rasterizer, dense autograd oracle
(counterpart of ``skelsplat_tpu/ops/rasterizer.py``).

For N ≤ 19 static Gaussians the reference's binning and radix sort
collapse to one stable depth argsort plus a per-pixel tile-rect gate.
Gradients come from autograd of this forward, with the α clamp made
straight-through (``geometry.alpha_clamp``) as the reference backward does.

Shapes: Gaussian quantities are (..., N); pixel sets add trailing axes,
so one call may cover a batch of views.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.core.cameras import Camera
from skelsplat_tpu_torch.core.gaussians import GaussianParams


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities, each (..., N[, k])."""

    pix: torch.Tensor          # (…,N,2) projected pixel centers
    depth: torch.Tensor        # (…,N) view-space z
    conic: torch.Tensor        # (…,N,3) inverse dilated 2D covariance (a,b,c)
    opacity_eff: torch.Tensor  # (…,N) opacity × antialiasing rescale
    radius: torch.Tensor       # (…,N) 3σ screen radius (0 ⇒ culled)
    rect_min: torch.Tensor     # (…,N,2) tile rect (int32)
    rect_max: torch.Tensor     # (…,N,2)
    valid: torch.Tensor        # (…,N) bool, survives every preprocess cull


def preprocess_gaussians(xyz, cov6, opacity, camera: Camera, W: int, H: int,
                         antialiasing: bool = False) -> Preprocessed:
    """Screen-space preprocess of all N Gaussians for one view or a batch of
    views (``camera`` fields with a leading view axis)."""
    cam = camera.per_point()
    p_view = geometry.view_transform_point(xyz, cam.view4)
    depth = p_view[..., 2]
    in_front = depth > geometry.NEAR_Z

    p_proj = geometry.project_point_full(xyz, cam.full4)
    pix = torch.stack(
        [geometry.ndc2pix(p_proj[..., 0], cam.width),
         geometry.ndc2pix(p_proj[..., 1], cam.height)], dim=-1)

    cov2d = geometry.ewa_cov2d_render(
        xyz, cov6, cam.view4, cam.focal_x, cam.focal_y,
        cam.tan_fovx, cam.tan_fovy)

    det_cov = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] ** 2
    conic, radius, det_dilated = geometry.cov2d_to_conic_radius(cov2d)

    if antialiasing:
        h_scaling = torch.sqrt(torch.clamp(det_cov / det_dilated, min=0.000025))
    else:
        h_scaling = torch.ones_like(det_cov)
    opacity_eff = opacity.reshape(opacity.shape[:-1]) * h_scaling

    rect_min, rect_max = geometry.tile_rect(pix, radius, W, H)
    area = ((rect_max[..., 0] - rect_min[..., 0])
            * (rect_max[..., 1] - rect_min[..., 1]))

    valid = in_front & (det_dilated != 0.0) & (area > 0)
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Preprocessed(pix, depth, conic, opacity_eff, radius,
                        rect_min, rect_max, valid)


def depth_order(pp: Preprocessed) -> torch.Tensor:
    """(…,N) slot → Gaussian index, front to back. Stable, as the reference's
    radix sort is; invalid splats sort last at +inf."""
    key = torch.where(pp.valid, pp.depth,
                      torch.full_like(pp.depth, float("inf")))
    return torch.argsort(key, dim=-1, stable=True)


def _trail(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * n)


def composite_weights(pp: Preprocessed, dx, dy, tile_gate):
    """Front-to-back compositing weights of every Gaussian at a pixel set.

    dx, dy, tile_gate: (…, N, *pix) offsets (center − pixel) and tile-rect
    gate. Returns (contrib (…,N,*pix), order (…,N)): contrib[i] is α·T of
    depth-sorted slot i and ``order`` maps slot → Gaussian index.
    """
    npix = dx.dim() - pp.depth.dim()
    ax = pp.depth.dim() - 1
    a_c, b_c, c_c = (_trail(pp.conic[..., k], npix) for k in range(3))
    power = (-0.5 * (a_c * dx * dx + c_c * dy * dy) - b_c * dx * dy)
    alpha = geometry.alpha_clamp(_trail(pp.opacity_eff, npix) * torch.exp(power))
    gate = (_trail(pp.valid, npix) & (power <= 0.0)
            & (alpha >= geometry.ALPHA_MIN) & tile_gate)

    order = depth_order(pp)
    idx = _trail(order, npix).expand(gate.shape)
    a = torch.take_along_dim(torch.where(gate, alpha, torch.zeros_like(alpha)),
                             idx, dim=ax)
    gate_s = torch.take_along_dim(gate, idx, dim=ax)
    one_minus = 1.0 - a
    # exclusive transmittance T_i = Π_{k<i}(1−a_k), as a shifted inclusive
    # cumprod so its f32 rounding is the sequential T *= (1−α)
    shifted = torch.cat([torch.ones_like(one_minus.narrow(ax, 0, 1)),
                         one_minus.narrow(ax, 0, one_minus.shape[ax] - 1)],
                        dim=ax)
    T = torch.cumprod(shifted, dim=ax)
    test = T * one_minus
    # the first gated slot whose transmittance would drop below T_MIN ends
    # the pixel before contributing
    stop = (gate_s & (test < geometry.T_MIN)).to(torch.int32)
    done_before = torch.cumsum(stop, dim=ax) - stop
    live = gate_s & (done_before == 0) & (test >= geometry.T_MIN)
    contrib = torch.where(live, a * T, torch.zeros_like(a))
    return contrib, order


def _unsort(contrib: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Slot-ordered (…,N,*pix) → Gaussian (channel) order."""
    npix = contrib.dim() - order.dim()
    inv = torch.argsort(order, dim=-1)
    return torch.take_along_dim(
        contrib, _trail(inv, npix).expand(contrib.shape), dim=order.dim() - 1)


def _tile_gate(pp: Preprocessed, ys: torch.Tensor, xs: torch.Tensor):
    """(…,N,rows,W) bool: the pixel's 16×16 tile lies in the splat rect."""
    tile_x = xs // geometry.BLOCK_X
    tile_y = (ys // geometry.BLOCK_Y)[:, None]
    r0, r1 = _trail(pp.rect_min, 2), _trail(pp.rect_max, 2)
    return ((tile_x >= r0[..., 0, :, :]) & (tile_x < r1[..., 0, :, :])
            & (tile_y >= r0[..., 1, :, :]) & (tile_y < r1[..., 1, :, :]))


def pixel_offsets(pp: Preprocessed, ys: torch.Tensor, xs: torch.Tensor):
    """(dx, dy, tile_gate), each (…,N,rows,W), for integer pixel rows ``ys``
    and columns ``xs``."""
    shape = pp.depth.shape + (ys.shape[0], xs.shape[0])
    dx = _trail(pp.pix[..., 0], 2) - xs.to(torch.float32)
    dy = _trail(pp.pix[..., 1], 2) - ys.to(torch.float32)[:, None]
    return dx.expand(shape), dy.expand(shape), _tile_gate(pp, ys, xs)


def rasterize_dense(xyz, cov6, opacity, camera: Camera, W: int, H: int,
                    antialiasing: bool = False, features=None):
    """The full (…,N,H,W) per-joint image (one-hot features: channel j is
    Gaussian j's α·T), or with (N,C) ``features`` the (…,C,H,W) image
    Σ_n α·T·features[n]. Returns dict(render, radii, invdepth)."""
    pp = preprocess_gaussians(xyz, cov6, opacity, camera, W, H, antialiasing)
    dev = pp.depth.device
    ys = torch.arange(H, dtype=torch.int32, device=dev)
    xs = torch.arange(W, dtype=torch.int32, device=dev)
    contrib, order = composite_weights(pp, *pixel_offsets(pp, ys, xs))
    depth_s = torch.take_along_dim(pp.depth, order, dim=-1)
    inv_d = torch.where(depth_s != 0.0, 1.0 / depth_s, torch.zeros_like(depth_s))
    invdepth = torch.sum(contrib * _trail(inv_d, 2), dim=-3)
    image = (_unsort(contrib, order) if features is None
             else torch.einsum("...nhw,...nc->...chw", contrib,
                               features[order]))
    return {"render": image, "radii": pp.radius, "invdepth": invdepth}


def render(params: GaussianParams, camera: Camera, W: int, H: int,
           scaling_modifier: float = 1.0, antialiasing: bool = False,
           features=None):
    """Render one view (or a batch of views) with the reference dispatch's
    [0,1] clamp. Returns dict(render, radii, depth, visibility_filter)."""
    cov6 = params.covariance(scaling_modifier)
    out = rasterize_dense(params.xyz, cov6, params.opacity, camera, W, H,
                          antialiasing=antialiasing, features=features)
    out["render"] = torch.clamp(out["render"], 0.0, 1.0)
    out["depth"] = out.pop("invdepth")
    out["visibility_filter"] = out["radii"] > 0
    return out
