"""The "cuda" renderer's macro step without autograd: the EWA preprocess,
depth sort and slot pack of every visited view, K1, and their backward by
hand (no counterpart in the JAX package, which leaves the preprocess and
its autodiff to XLA).

On the card a macro step is three launches over all of its views:

* kernel A, ``preprocess_pack`` (``csrc/preprocess.cu``): each Gaussian's
  screen-space quantities at each view, read from the scene's own
  parameters (no per-view copies), the stable depth order, K1's slot
  records in slot order and the GT profile rows gathered into slot order;
* K1, ``cuda_raster.raster_loss_grad``, as before: S, C and the slot
  gradients dg;
* kernel B, ``preprocess_grad``: each view's loss S/max(C,1) + λ·(limb
  prior) and its parameter gradients, dg taken back through the order and
  the preprocess (whose intermediates it recomputes), plus λ·∂(limb
  prior)/∂xyz.

``view_forward`` is the first two, ``preprocess_grad`` the third.

On CPU tensors the same steps are plain PyTorch: ``preprocess_gaussians``
+ ``cuda_raster.slot_pack``, K1's plain version and
``preprocess_grad_plain``, the analytic backward with kernel B's formulas.

Where autograd of the forward is finite, the backward follows its
conventions: a clamp passes the gradient at its edges; ``where(det != 0,
1/det, 0)``, ceil, trunc and the integer rect pass none; the sigmoid's
derivative is s·(1−s), 0 at an infinite logit; |x|'s is 0 at 0.
"""

from __future__ import annotations

import ctypes

import torch

from skelsplat_tpu_torch import losses as loss_registry
from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.core.gaussians import (PARAM_FIELDS,
                                                GaussianParams)
from skelsplat_tpu_torch.ops import _build, cuda_raster, rasterizer

N_GRAD = cuda_raster.N_GRAD


def limb_pairs(consistency: str, scene_type: str):
    """The limb prior's four (joint, joint) pairs (left arm, right arm,
    left leg, right leg), or None for no prior."""
    if consistency == "none":
        return None
    if consistency != "3D_length_consistency":
        raise ValueError(f"unknown consistency loss {consistency!r}")
    return loss_registry.LIMB_PAIRS[scene_type]


def _scenes(params: GaussianParams) -> GaussianParams:
    """Each field as a contiguous (S, N, k) tensor over the scene axes."""
    return params.map(lambda x: x.reshape((-1,) + tuple(x.shape[-2:]))
                      .contiguous())


def _per_view(params: GaussianParams, A: int) -> GaussianParams:
    """(S·A, N, k): scene s's parameters at its A views s·A … s·A+A−1."""
    return _scenes(params).map(lambda x: x.repeat_interleave(A, dim=0))


def _check(params: GaussianParams, cameras, A: int, V: int):
    for name in PARAM_FIELDS:
        t = getattr(params, name)
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != cameras.view4.device:
            raise ValueError(f"{name} is on {t.device}, cameras on "
                             f"{cameras.view4.device}")
    n = params.xyz.shape[-2]
    if not 0 < n <= cuda_raster.MAX_SLOTS:
        raise ValueError(f"N={n} Gaussians outside 1..{cuda_raster.MAX_SLOTS}")
    scenes = params.xyz.numel() // (3 * n)
    if A < 1 or scenes * A != V or cameras.view4.shape[0] != V:
        raise ValueError(f"{scenes} scenes of {A} views need {scenes * A} "
                         f"views, got {V} and cameras of "
                         f"{cameras.view4.shape[0]}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def preprocess_pack_plain(params: GaussianParams, cameras,
                          prof: cuda_raster.ViewProfiles, A: int,
                          antialiasing: bool = False):
    """Kernel A's plain version on any device: (pack (V,N,16), order (V,N)
    int32 slot → Gaussian, p1s (V,N,H), p2s (V,N,W)) of the V = S·A views
    of ``cameras`` and ``prof``, scene s's parameters at views s·A …
    s·A+A−1, through ``preprocess_gaussians`` and ``slot_pack``."""
    V = prof.p1.shape[0]
    _check(params, cameras, A, V)
    p = _per_view(params, A)
    pp = rasterizer.preprocess_gaussians(
        p.xyz, p.covariance(), p.opacity, cameras, prof.p2.shape[-1],
        prof.p1.shape[-1], antialiasing)
    gd, aux, p1s, p2s = cuda_raster.slot_pack(pp, prof)
    order = rasterizer.depth_order(pp).to(torch.int32)
    return torch.cat([gd, aux], dim=-1).contiguous(), order, p1s, p2s


class _Terms:
    """The forward's intermediates that the backward reads, (V,N) tensors
    (lists of them for vectors), computed in the forward's operation order
    (``core/geometry.py``, ``rasterizer.preprocess_gaussians``): what
    kernel B recomputes in registers."""

    def __init__(self, p: GaussianParams, cam, W: int, H: int,
                 antialiasing: bool):
        def col(x):                    # per-view scalar → (V,1)
            return x.reshape(-1, 1)

        def mat(M, j, k):
            return M[:, j, k].reshape(-1, 1)

        self.xyz = [p.xyz[..., k] for k in range(3)]
        x, y, z = self.xyz
        sc = torch.exp(p.log_scales)
        self.sc = [sc[..., k] for k in range(3)]
        self.q = [p.quats[..., k] for k in range(4)]
        q0, q1, q2, q3 = self.q
        self.nrm = torch.sqrt(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3)
        self.qn = [qk / self.nrm for qk in self.q]
        r, qx, qy, qz = self.qn
        self.R = [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - r * qz),
                  2 * (qx * qz + r * qy), 2 * (qx * qy + r * qz),
                  1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - r * qx),
                  2 * (qx * qz - r * qy), 2 * (qy * qz + r * qx),
                  1 - 2 * (qx * qx + qy * qy)]
        self.L = [self.R[3 * i + k] * self.sc[k]
                  for i in range(3) for k in range(3)]
        L = self.L

        def dot(i, j):
            return (L[3 * i] * L[3 * j] + L[3 * i + 1] * L[3 * j + 1]
                    + L[3 * i + 2] * L[3 * j + 2])

        self.cov = [dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2),
                    dot(2, 2)]
        self.op = torch.sigmoid(p.opacity_logit[..., 0])

        V4, F4 = cam.view4, cam.full4
        self.view = [[mat(V4, j, k) for k in range(4)] for j in range(3)]
        self.full = [[mat(F4, j, k) for k in range(4)] for j in (0, 1, 3)]

        def affine(row):
            return x * row[0] + y * row[1] + z * row[2] + row[3]

        self.t = [affine(row) for row in self.view]
        self.hom = [affine(row) for row in self.full]
        self.w = 1.0 / (self.hom[2] + 1.0e-7)
        self.width, self.height = col(cam.width), col(cam.height)
        self.px = geometry.ndc2pix(self.hom[0] * self.w, self.width)
        self.py = geometry.ndc2pix(self.hom[1] * self.w, self.height)

        t0, t1, tz = self.t
        self.lim = [1.3 * col(cam.tan_fovx), 1.3 * col(cam.tan_fovy)]
        self.u = [t0 / tz, t1 / tz]
        self.uc = [torch.clamp(u, -lim, lim)
                   for u, lim in zip(self.u, self.lim)]
        tx, ty = self.uc[0] * tz, self.uc[1] * tz
        self.fx, self.fy = col(cam.focal_x), col(cam.focal_y)
        self.s = [self.fx / tz, -(self.fx * tx) / (tz * tz), self.fy / tz,
                  -(self.fy * ty) / (tz * tz)]
        s0, s1, s2, s3 = self.s
        W0, W1, W2 = self.view
        self.b0 = [s0 * W0[k] + s1 * W2[k] for k in range(3)]
        self.b1 = [s2 * W1[k] + s3 * W2[k] for k in range(3)]
        xx, xy, xz, yy, yz, zz = self.cov

        def quad(u, v):
            return (u[0] * v[0] * xx + u[1] * v[1] * yy + u[2] * v[2] * zz
                    + (u[0] * v[1] + u[1] * v[0]) * xy
                    + (u[0] * v[2] + u[2] * v[0]) * xz
                    + (u[1] * v[2] + u[2] * v[1]) * yz)

        self.c = [quad(self.b0, self.b0), quad(self.b0, self.b1),
                  quad(self.b1, self.b1)]
        c0, c1, c2 = self.c
        cov2d = torch.stack(self.c, dim=-1)
        conic, radius, self.det = geometry.cov2d_to_conic_radius(cov2d)
        self.conic = conic.unbind(-1)
        self.cx = c0 + geometry.H_VAR
        self.cy = c1
        self.cz = c2 + geometry.H_VAR
        self.di = torch.where(self.det != 0.0, 1.0 / self.det,
                              torch.zeros_like(self.det))
        if antialiasing:
            self.det_cov = c0 * c2 - c1 ** 2
            self.ratio = self.det_cov / self.det
            self.h = torch.sqrt(torch.clamp(self.ratio, min=0.000025))
            self.oe = self.op * self.h
        else:
            self.oe = self.op
        pix = torch.stack([self.px, self.py], dim=-1)
        rect_min, rect_max = geometry.tile_rect(pix, radius, W, H)
        area = ((rect_max[..., 0] - rect_min[..., 0])
                * (rect_max[..., 1] - rect_min[..., 1]))
        self.valid = (tz > geometry.NEAR_Z) & (self.det != 0.0) & (area > 0)


def _limbs(xyz, limbs, lam: float):
    """(cons (V,), λ·∂cons/∂xyz (V,N,3)) of the limb prior
    |‖l_arm‖−‖r_arm‖| + |‖l_leg‖−‖r_leg‖| at every view's (V,N,3) xyz."""
    g = torch.zeros_like(xyz)
    if limbs is None:
        return torch.zeros_like(xyz[:, 0, 0]), g
    ds, lens = [], []
    for a, b in limbs:
        d = xyz[:, a] - xyz[:, b]
        ds.append(d)
        lens.append(torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                               + d[:, 2] * d[:, 2]))
    cons = torch.abs(lens[0] - lens[1]) + torch.abs(lens[2] - lens[3])
    g_len = []
    for i in (0, 2):
        g_i = lam * torch.sign(lens[i] - lens[i + 1])
        g_len += [g_i, -g_i]
    for (a, b), d, length, g_l in zip(limbs, ds, lens, g_len):
        g_ss = (g_l / (2.0 * length))[:, None]
        g_d = g_ss * d + g_ss * d
        g[:, a] += g_d
        g[:, b] -= g_d
    return cons, g


def preprocess_grad_plain(params: GaussianParams, cameras, order, S, C, dg,
                          A: int, W: int, H: int, antialiasing: bool = False,
                          limbs=None, lambda_consistency: float = 0.0):
    """Kernel B's plain version on any device: (losses (V,), gradients
    GaussianParams (V,N,·)) of each view's S/max(C,1) + λ·(limb prior), from
    K1's (S (V,), C (V,), dg (V,N,6)) in the slot order ``order`` (V,N)
    of ``preprocess_pack``, by the chain rule through the preprocess
    (``_Terms``) and the limb prior of ``limbs`` (``limb_pairs``)."""
    V, N = order.shape
    _check(params, cameras, A, V)
    p = _per_view(params, A)
    f = _Terms(p, cameras, W, H, antialiasing)
    zero = torch.zeros((), dtype=torch.float32, device=dg.device)
    cf = torch.clamp(C, min=1).to(torch.float32)
    g_slot = dg * (1.0 / cf)[:, None, None]
    g = torch.zeros_like(g_slot).scatter(
        1, order.long()[..., None].expand(V, N, N_GRAD), g_slot)
    g_px, g_py, g_ca, g_cb, g_cc, g_opa = g.unbind(-1)

    # opacity: opa = where(valid, op·h, 0), op = sigmoid(logit)
    g_oe = torch.where(f.valid, g_opa, zero)
    g_op = g_oe * f.h if antialiasing else g_oe
    g_logit = (g_op * (1 - f.op)) * f.op

    # pixel centre: ((hom·w + 1)·size − 1)·0.5, w = 1/(hom3 + 1e-7)
    g_p0 = (g_px * 0.5) * f.width
    g_p1 = (g_py * 0.5) * f.height
    g_hom0, g_hom1 = g_p0 * f.w, g_p1 * f.w
    g_w = g_p0 * f.hom[0] + g_p1 * f.hom[1]
    g_hom3 = -g_w * (f.w * f.w)
    F0, F1, F3 = f.full
    gx_pix = [g_hom0 * F0[k] + g_hom1 * F1[k] + g_hom3 * F3[k]
              for k in range(3)]

    # conic = [cz, −cy, cx]·di, di = where(det != 0, 1/det, 0)
    g_di = g_ca * f.cz + g_cb * (-f.cy) + g_cc * f.cx
    g_cx, g_cy, g_cz = g_cc * f.di, -(g_cb * f.di), g_ca * f.di
    g_det = torch.where(f.det != 0.0, -g_di * (f.di * f.di), zero)
    if antialiasing:    # h = sqrt(clamp(det_cov/det, min=2.5e-5))
        g_h = g_oe * f.op
        g_ratio = torch.where(f.ratio >= 0.000025, g_h / (2.0 * f.h), zero)
        g_det_cov = g_ratio / f.det
        g_det = g_det + -g_ratio * (f.ratio / f.det)
    g_cx = g_cx + g_det * f.cz
    g_cz = g_cz + g_det * f.cx
    g_cy = g_cy + ((-g_det) * f.cy + (-g_det) * f.cy)
    g_c0, g_c1, g_c2 = g_cx, g_cy, g_cz
    if antialiasing:    # det_cov = c0·c2 − c1²
        c0, c1, c2 = f.c
        g_c0 = g_c0 + g_det_cov * c2
        g_c2 = g_c2 + g_det_cov * c0
        g_c1 = g_c1 + (-g_det_cov) * (2.0 * c1)

    # cov2d = [b0ᵀΣb0, b0ᵀΣb1, b1ᵀΣb1]
    xx, xy, xz, yy, yz, zz = f.cov
    b0, b1 = f.b0, f.b1

    def sigma(u):
        return [xx * u[0] + xy * u[1] + xz * u[2],
                xy * u[0] + yy * u[1] + yz * u[2],
                xz * u[0] + yz * u[1] + zz * u[2]]

    e0, e1 = sigma(b0), sigma(b1)
    g_b0 = [(g_c0 + g_c0) * e0[k] + g_c1 * e1[k] for k in range(3)]
    g_b1 = [g_c1 * e0[k] + (g_c2 + g_c2) * e1[k] for k in range(3)]

    def g_sym(k, l):
        """∂/∂ of the packed covariance entry (k, l)."""
        if k == l:
            return (g_c0 * (b0[k] * b0[k]) + g_c1 * (b0[k] * b1[k])
                    + g_c2 * (b1[k] * b1[k]))
        return (g_c0 * (b0[k] * b0[l] + b0[l] * b0[k])
                + g_c1 * (b0[k] * b1[l] + b0[l] * b1[k])
                + g_c2 * (b1[k] * b1[l] + b1[l] * b1[k]))

    g_cov = [g_sym(0, 0), g_sym(0, 1), g_sym(0, 2), g_sym(1, 1),
             g_sym(1, 2), g_sym(2, 2)]

    # b0 = s0·W0 + s1·W2, b1 = s2·W1 + s3·W2 (W the view rotation rows)
    W0, W1, W2 = f.view
    g_s0 = g_b0[0] * W0[0] + g_b0[1] * W0[1] + g_b0[2] * W0[2]
    g_s1 = g_b0[0] * W2[0] + g_b0[1] * W2[1] + g_b0[2] * W2[2]
    g_s2 = g_b1[0] * W1[0] + g_b1[1] * W1[1] + g_b1[2] * W1[2]
    g_s3 = g_b1[0] * W2[0] + g_b1[1] * W2[1] + g_b1[2] * W2[2]
    s0, s1, s2, s3 = f.s
    tz = f.t[2]
    dd = tz * tz
    g_tz = -g_s0 * (s0 / tz) + -g_s2 * (s2 / tz)
    # s1 = −(fx·tx)/tz², s3 = −(fy·ty)/tz²
    g_dd = -g_s1 * (s1 / dd) + -g_s3 * (s3 / dd)
    g_tx = (-(g_s1 / dd)) * f.fx
    g_ty = (-(g_s3 / dd)) * f.fy
    g_tz = g_tz + (g_dd * tz + g_dd * tz)
    # t_xy = clamp(t_xy/tz, ±1.3·tan(fov/2))·tz
    g_t = []
    for g_tc, u, uc, lim in zip((g_tx, g_ty), f.u, f.uc, f.lim):
        g_tz = g_tz + g_tc * uc
        g_u = torch.where((u >= -lim) & (u <= lim), g_tc * tz, zero)
        g_t.append(g_u / tz)
        g_tz = g_tz + -g_u * (u / tz)
    g_t.append(g_tz)
    gx_cov = [g_t[0] * W0[k] + g_t[1] * W1[k] + g_t[2] * W2[k]
              for k in range(3)]

    # Σ = L·Lᵀ, L = R·diag(s), s = exp(log_scales)
    L = f.L
    g_xx, g_xy, g_xz, g_yy, g_yz, g_zz = g_cov
    g_r = [[(g_xx + g_xx) * L[k] + g_xy * L[3 + k] + g_xz * L[6 + k]
            for k in range(3)],
           [g_xy * L[k] + (g_yy + g_yy) * L[3 + k] + g_yz * L[6 + k]
            for k in range(3)],
           [g_xz * L[k] + g_yz * L[3 + k] + (g_zz + g_zz) * L[6 + k]
            for k in range(3)]]
    R = f.R
    g_R = [g_r[i][k] * f.sc[k] for i in range(3) for k in range(3)]
    g_ls = [(g_r[0][k] * R[k] + g_r[1][k] * R[3 + k] + g_r[2][k] * R[6 + k])
            * f.sc[k] for k in range(3)]

    # R of the normalized quaternion (r, x, y, z)
    r, x, y, z = f.qn
    gR = g_R
    g_qn = [
        2 * (-z * gR[1] + y * gR[2] + z * gR[3] - x * gR[5] - y * gR[6]
             + x * gR[7]),
        2 * (y * gR[1] + z * gR[2] + y * gR[3] - 2 * x * gR[4] - r * gR[5]
             + z * gR[6] + r * gR[7] - 2 * x * gR[8]),
        2 * (-2 * y * gR[0] + x * gR[1] + r * gR[2] + x * gR[3] + z * gR[5]
             - r * gR[6] + z * gR[7] - 2 * y * gR[8]),
        2 * (-2 * z * gR[0] - r * gR[1] + x * gR[2] + r * gR[3]
             - 2 * z * gR[4] + y * gR[5] + x * gR[6] + y * gR[7])]
    # qn = q/‖q‖
    nrm = f.nrm
    g_nrm = -(g_qn[0] * (f.qn[0] / nrm) + g_qn[1] * (f.qn[1] / nrm)
              + g_qn[2] * (f.qn[2] / nrm) + g_qn[3] * (f.qn[3] / nrm))
    g_ss = g_nrm / (2.0 * nrm)
    g_q = [g_qn[k] / nrm + (g_ss * f.q[k] + g_ss * f.q[k]) for k in range(4)]

    cons, gx_limb = _limbs(p.xyz, limbs, lambda_consistency)
    losses = S / cf + cons * lambda_consistency
    g_xyz = torch.stack([gx_pix[k] + gx_cov[k] for k in range(3)],
                        dim=-1) + gx_limb
    return losses, GaussianParams(g_xyz, torch.stack(g_ls, dim=-1),
                                  torch.stack(g_q, dim=-1),
                                  g_logit[..., None])


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def _kernel_inputs(params: GaussianParams, cameras) -> list:
    """The scene parameters (S,N,k) and camera fields both kernels read,
    contiguous, in their C functions' order."""
    cams = [f.contiguous() for f in (
        cameras.view4, cameras.full4, cameras.focal_x, cameras.focal_y,
        cameras.tan_fovx, cameras.tan_fovy, cameras.width, cameras.height)]
    for f in cams:
        if f.dtype != torch.float32:
            raise TypeError(f"camera fields must be float32, got {f.dtype}")
    ps = _scenes(params)
    return [getattr(ps, f) for f in PARAM_FIELDS] + cams


def preprocess_pack(params: GaussianParams, cameras,
                    prof: cuda_raster.ViewProfiles, A: int,
                    antialiasing: bool = False):
    """Kernel A: (pack (V,N,16), order (V,N) int32, p1s, p2s) as
    ``preprocess_pack_plain`` gives them; by the kernel on CUDA tensors
    (float fields bitwise the plain version's on the card), by the plain
    version on CPU tensors."""
    if params.xyz.device.type == "cpu":
        return preprocess_pack_plain(params, cameras, prof, A, antialiasing)
    V, N, H = prof.p1.shape
    W = prof.p2.shape[-1]
    _check(params, cameras, A, V)
    ins = _kernel_inputs(params, cameras)
    B, spans = prof.B.contiguous(), prof.spans.contiguous()
    p1, p2 = prof.p1.contiguous(), prof.p2.contiguous()
    dev = p1.device
    pack = torch.empty((V, N, cuda_raster.PACK), dtype=torch.float32,
                       device=dev)
    order = torch.empty((V, N), dtype=torch.int32, device=dev)
    p1s, p2s = torch.empty_like(p1), torch.empty_like(p2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _build.launch(
        "preprocess_pack", dev, *(t.data_ptr() for t in ins), B.data_ptr(),
        spans.data_ptr(), p1.data_ptr(), p2.data_ptr(), V, A, N, H, W,
        int(antialiasing), sms, pack.data_ptr(), order.data_ptr(),
        p1s.data_ptr(), p2s.data_ptr())
    return pack, order, p1s, p2s


def preprocess_grad(params: GaussianParams, cameras, order, S, C, dg,
                    A: int, W: int, H: int, antialiasing: bool = False,
                    limbs=None, lambda_consistency: float = 0.0):
    """Kernel B: (losses (V,), gradients (V,N,·)) as
    ``preprocess_grad_plain`` gives them; by the kernel on CUDA tensors,
    by the plain version on CPU tensors."""
    if params.xyz.device.type == "cpu":
        return preprocess_grad_plain(params, cameras, order, S, C, dg, A, W,
                                     H, antialiasing, limbs,
                                     lambda_consistency)
    V, N = order.shape
    _check(params, cameras, A, V)
    for name, t, dtype, shape in (("order", order, torch.int32, (V, N)),
                                  ("S", S, torch.float32, (V,)),
                                  ("C", C, torch.int32, (V,)),
                                  ("dg", dg, torch.float32, (V, N, N_GRAD))):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    ins = _kernel_inputs(params, cameras)
    pairs = [j for pair in (limbs or ((0, 0),) * 4) for j in pair]
    if max(pairs) >= N:
        raise ValueError(f"limb pairs {limbs} outside {N} joints")
    dev = order.device
    losses = torch.empty(V, dtype=torch.float32, device=dev)
    grads = GaussianParams(*(torch.empty((V, N, k), dtype=torch.float32,
                                         device=dev) for k in (3, 3, 4, 1)))
    _build.launch(
        "preprocess_grad", dev, *(t.data_ptr() for t in ins),
        order.data_ptr(), S.data_ptr(), C.data_ptr(), dg.data_ptr(), V, A, N,
        H, W, int(antialiasing), int(limbs is not None), *pairs,
        ctypes.c_float(lambda_consistency), losses.data_ptr(),
        grads.xyz.data_ptr(), grads.log_scales.data_ptr(),
        grads.quats.data_ptr(), grads.opacity_logit.data_ptr())
    return losses, grads


def view_forward(params: GaussianParams, cameras,
                 prof: cuda_raster.ViewProfiles, A: int,
                 antialiasing: bool = False,
                 loss_function: str = "l2_gaussian"):
    """The forward half of a macro step: (order (V,N), S (V,), C (V,),
    dg (V,N,6)) of the V = S·A views of ``cameras`` and ``prof`` (scene
    s's A views one after another), ``params`` with S scenes on its
    leading axes; kernel A then K1 on the card, their plain versions on
    the CPU. ``preprocess_grad`` of these is the backward half: each
    view's loss S/max(C,1) + λ·(limb prior) and its gradient with respect
    to the scene's parameters."""
    if loss_function not in cuda_raster.CUDA_LOSSES:
        raise ValueError(f"cuda kernel does not implement {loss_function!r}")
    pack, order, p1s, p2s = preprocess_pack(params, cameras, prof, A,
                                            antialiasing)
    S, C, dg = cuda_raster.raster_loss_grad(
        pack, p1s, p2s, prof.img, loss_function != "l2_gaussian")
    return order, S, C, dg
