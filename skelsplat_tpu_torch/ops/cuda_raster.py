"""Render + GT heatmap + masked loss + analytic gradient in one CUDA kernel
(counterpart of ``skelsplat_tpu/ops/pallas_raster.py``).

Per macro step the trainer preprocesses all V views at once (torch, N-sized
math), sorts each view's splats by depth, packs one 16-float record per
slot and makes ONE launch covering every view:

* K1, ``raster_loss_grad`` (replaces ``pallas_raster.py::_bwd_kernel``):
  pass 1 composites the slots front to back per pixel, evaluates the
  closed-form GT gt = p1'·p2 + B and accumulates S = Σ mask·err and
  C = Σ mask; pass 2 walks the slots back to front and accumulates
  dg = ∂S/∂(px, py, conic a/b/c, opa) per slot.
* K2, ``raster_loss`` (replaces ``_fwd_kernel``): pass 1 only, for a loss
  evaluated without a gradient.

Each wrapper launches the kernel for CUDA tensors (counting the launch in
``launches``) and runs its plain PyTorch version, the same two passes over
row chunks, for CPU tensors. Autograd sees ``_RasterLossFn``, whose backward
is dg scaled by the loss cotangent; gradients reach xyz, scales, quats and
opacity through autograd of the preprocess and the depth-order gather.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from skelsplat_tpu_torch import losses as loss_registry
from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.ops import heatmaps as hm
from skelsplat_tpu_torch.ops import rasterizer

# Below full f32, geometry products lose ~0.3% of covariance accuracy, far
# above the sub-mm parity budget; the port runs every f32 product at full
# precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# Slot record, one per depth-sorted splat (csrc/raster_math.cuh):
# [px, py, conic a, b, c, opa | rect x0, y0, x1, y1 (tiles) | B |
#  GT support rows gy0, gy1 and columns gx0, gx1 (pixels) | unused]
PACK = 16
N_GRAD = 6           # px, py, conic a, b, c, opa
MAX_SLOTS = 32       # the kernel keeps per-slot α and T in registers
IDX_PX, IDX_PY, IDX_CA, IDX_CB, IDX_CC, IDX_OPA = range(6)
IDX_RX0, IDX_RY0, IDX_RX1, IDX_RY1, IDX_B = 6, 7, 8, 9, 10
IDX_GY0, IDX_GY1, IDX_GX0, IDX_GX1 = 11, 12, 13, 14

CUDA_LOSSES = ("l2_gaussian", "l1_gaussian", "l1_masked")

# kernel launches by wrapper; chip_smoke.py resets and reads these
launches = {"raster_loss_grad": 0, "raster_loss": 0}


class ViewProfiles(NamedTuple):
    """Per-scene-constant GT state of V views, so that
    gt[v, j, y, x] = p1[v, j, y]·p2[v, j, x] + B[v, j].

    p1 (V,N,H) row profiles scaled by amp/(mx−mn+ε); p2 (V,N,W) column
    profiles; B (V,N) = −mn/(mx−mn+ε) ≤ 0; spans (V,N,4) the nonzero
    [gy0, gy1, gx0, gx1) support of the GT (gt > 0 only inside it); img
    (V,2) each view's true (width, height).
    """

    p1: torch.Tensor
    p2: torch.Tensor
    B: torch.Tensor
    spans: torch.Tensor
    img: torch.Tensor

    def take(self, idx) -> "ViewProfiles":
        return ViewProfiles(*(f[idx] for f in self))


def _nz_span(prof: torch.Tensor):
    """First / one-past-last nonzero index along the last axis, (0, 0) for
    all-zero rows, as float32."""
    nz = prof > 0.0
    L = prof.shape[-1]
    has = nz.any(dim=-1)
    first = torch.argmax(nz.to(torch.uint8), dim=-1)
    last = L - torch.argmax(nz.flip(-1).to(torch.uint8), dim=-1)
    zero = torch.zeros_like(first)
    return (torch.where(has, first, zero).to(torch.float32),
            torch.where(has, last, zero).to(torch.float32))


def view_profiles(spec: hm.HeatmapSpec, W: int, H: int) -> ViewProfiles:
    """GT profiles of every view of ``spec`` (computed once per scene: the
    spec is frozen at the initial covariance)."""
    dev = spec.y0.device
    ys = torch.arange(H, dtype=torch.int32, device=dev)
    xs = torch.arange(W, dtype=torch.int32, device=dev)
    p1 = hm._profile(ys, spec.y0[..., None], spec.sigma1[..., None],
                     spec.r1[..., None], spec.sum1[..., None],
                     spec.height[..., None])
    p2 = hm._profile(xs, spec.x0[..., None], spec.sigma2[..., None],
                     spec.r2[..., None], spec.sum2[..., None],
                     spec.width[..., None])
    denom = spec.mx - spec.mn + hm.NORM_EPS
    A = spec.amp / denom
    B = -spec.mn / denom
    p1 = p1 * A[..., None]
    gy0, gy1 = _nz_span(p1)
    gx0, gx1 = _nz_span(p2)
    spans = torch.stack([gy0, gy1, gx0, gx1], dim=-1)
    img = torch.stack([spec.width[..., 0], spec.height[..., 0]], dim=-1)
    return ViewProfiles(p1.contiguous(), p2.contiguous(), B, spans,
                        img.contiguous())


# ---------------------------------------------------------------------------
# Plain PyTorch versions of K1 and K2
# ---------------------------------------------------------------------------

def _err(d, l1: bool):
    """|d| for the l1 family, d² for l2_gaussian."""
    return torch.abs(d) if l1 else d * d


def _derr(d, l1: bool):
    """∂err/∂render: sign(d) for l1 (sign(0) = 0), 2d for l2."""
    return torch.sign(d) if l1 else 2.0 * d


def _raster_loss_plain(pack, p1, p2, img, l1: bool, with_grad: bool,
                       rows: int = 64):
    """The kernel's two passes as tensor ops over row chunks, slot by slot
    in depth order. Returns (S (V,), C (V,) int32, dg (V,N,6) or None)."""
    V, N, _ = pack.shape
    H, W = p1.shape[-1], p2.shape[-1]
    dev = pack.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    S = torch.zeros(V, dtype=torch.float32, device=dev)
    C = torch.zeros(V, dtype=torch.int64, device=dev)
    dg = torch.zeros(V, N, N_GRAD, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    tile_x = torch.floor(xs / geometry.BLOCK_X)
    img_w = img[:, 0].reshape(V, 1, 1)
    img_h = img[:, 1].reshape(V, 1, 1)

    def slot(i, k):
        return pack[:, i, k].reshape(V, 1, 1)

    def alpha_of(i, ys, tile_y):
        dx = slot(i, IDX_PX) - xs
        dy = slot(i, IDX_PY) - ys
        a, b, c = slot(i, IDX_CA), slot(i, IDX_CB), slot(i, IDX_CC)
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        E = torch.exp(power)
        alpha = torch.clamp(slot(i, IDX_OPA) * E, max=geometry.ALPHA_MAX)
        tg = ((tile_x >= slot(i, IDX_RX0)) & (tile_x < slot(i, IDX_RX1))
              & (tile_y >= slot(i, IDX_RY0)) & (tile_y < slot(i, IDX_RY1)))
        gate = (power <= 0.0) & (alpha >= geometry.ALPHA_MIN) & tg
        return alpha, gate, E, dx, dy

    for y0 in range(0, H, rows):
        R = min(rows, H - y0)
        ys = torch.arange(y0, y0 + R, dtype=torch.float32,
                          device=dev)[:, None]
        tile_y = torch.floor(ys / geometry.BLOCK_Y)
        in_img = (ys < img_h) & (xs < img_w)

        def gt_of(i):
            return (p1[:, i, y0:y0 + R].reshape(V, R, 1)
                    * p2[:, i].reshape(V, 1, W) + slot(i, IDX_B))

        T = torch.ones(V, R, W, dtype=torch.float32, device=dev)
        al, Ti = [], []
        for i in range(N):                                   # pass 1
            alpha, gate, _, _, _ = alpha_of(i, ys, tile_y)
            a_i = torch.where(gate, alpha, zero)
            test = T * (1.0 - a_i)
            ge = test >= geometry.T_MIN
            live = gate & ge
            contrib = torch.where(live, a_i * T, zero)
            r = torch.clamp(contrib, 0.0, 1.0)
            gt = gt_of(i)
            mask = ((gt > 0.0) | (r > 0.0)) & in_img
            S = S + torch.sum(torch.where(mask, _err(r - gt, l1), zero),
                              dim=(1, 2))
            C = C + torch.sum(mask, dim=(1, 2))
            al.append(torch.where(live, a_i, zero))
            Ti.append(T)
            # gated and below T_MIN → early-out, encoded as T := 0
            T = torch.where(gate, torch.where(ge, test, zero), T)
        if not with_grad:
            continue
        sfx = torch.zeros(V, R, W, dtype=torch.float32, device=dev)
        for i in range(N - 1, -1, -1):                       # pass 2
            a_i, T_i = al[i], Ti[i]
            live = a_i > 0.0
            r = torch.clamp(a_i * T_i, 0.0, 1.0)
            gt = gt_of(i)
            mask = ((gt > 0.0) | (r > 0.0)) & in_img
            ghat = torch.where(mask & live, _derr(r - gt, l1), zero)
            _, _, E, dx, dy = alpha_of(i, ys, tile_y)
            dalpha = torch.where(live, T_i * ghat - sfx / (1.0 - a_i), zero)
            # the reference chains through the α clamp unconditionally:
            # dα/dpower is the unclamped opa·E
            dpower = dalpha * (slot(i, IDX_OPA) * E)
            ca, cb, cc = slot(i, IDX_CA), slot(i, IDX_CB), slot(i, IDX_CC)
            terms = (dpower * (-ca * dx - cb * dy),
                     dpower * (-cc * dy - cb * dx),
                     dpower * (-0.5 * dx * dx),
                     dpower * (-dx * dy),
                     dpower * (-0.5 * dy * dy),
                     dalpha * E)
            dg[:, i] += torch.stack([t.sum(dim=(1, 2)) for t in terms], dim=-1)
            sfx = sfx + a_i * T_i * ghat
    return S, C.to(torch.int32), (dg if with_grad else None)


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def _check_inputs(pack, p1, p2, img):
    ts = {"pack": pack, "p1": p1, "p2": p2, "img": img}
    for name, t in ts.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != pack.device:
            raise ValueError(f"{name} is on {t.device}, pack on {pack.device}")
    if pack.dim() != 3 or pack.shape[2] != PACK:
        raise ValueError(f"pack must be (V, N, {PACK}), got {tuple(pack.shape)}")
    V, N, _ = pack.shape
    if not 0 < N <= MAX_SLOTS:
        raise ValueError(f"N={N} slots outside 1..{MAX_SLOTS}")
    if p1.dim() != 3 or p1.shape[:2] != (V, N):
        raise ValueError(f"p1 must be ({V}, {N}, H), got {tuple(p1.shape)}")
    if p2.dim() != 3 or p2.shape[:2] != (V, N):
        raise ValueError(f"p2 must be ({V}, {N}, W), got {tuple(p2.shape)}")
    if img.shape != (V, 2):
        raise ValueError(f"img must be ({V}, 2), got {tuple(img.shape)}")


def _launch(pack, p1, p2, img, l1: bool, with_grad: bool):
    from skelsplat_tpu_torch.ops import _build

    lib = _build.load_library()
    V, N, _ = pack.shape
    H, W = p1.shape[-1], p2.shape[-1]
    n_tiles = _build.n_tiles(W, H)
    n_f = 1 + (N * N_GRAD if with_grad else 0)
    dev = pack.device
    part_f = torch.empty(V * n_f * n_tiles, dtype=torch.float32, device=dev)
    part_c = torch.empty(V * n_tiles, dtype=torch.int32, device=dev)
    S = torch.empty(V, dtype=torch.float32, device=dev)
    C = torch.empty(V, dtype=torch.int32, device=dev)
    dg = torch.empty((V, N, N_GRAD) if with_grad else (1,),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.skelsplat_raster_loss(
            pack.data_ptr(), p1.data_ptr(), p2.data_ptr(), img.data_ptr(),
            V, N, H, W, int(l1), int(with_grad),
            part_f.data_ptr(), part_c.data_ptr(), S.data_ptr(),
            C.data_ptr(), dg.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"raster_loss kernel launch failed: "
                           f"{_build.error_string(rc)} (cudaError {rc})")
    return S, C, (dg if with_grad else None)


def raster_loss_grad(pack, p1, p2, img, l1: bool):
    """K1: (S (V,), C (V,) int32, dg (V,N,6)) of depth-sorted slot records
    ``pack`` (V,N,16) against profiles p1 (V,N,H), p2 (V,N,W) of the same
    slot order and true image sizes ``img`` (V,2)."""
    _check_inputs(pack, p1, p2, img)
    if pack.device.type == "cpu":
        return _raster_loss_plain(pack, p1, p2, img, l1, True)
    if pack.device.type != "cuda":
        raise ValueError(f"unsupported device {pack.device}")
    out = _launch(pack, p1, p2, img, l1, True)
    launches["raster_loss_grad"] += 1
    return out


def raster_loss(pack, p1, p2, img, l1: bool):
    """K2: (S (V,), C (V,) int32), pass 1 of K1."""
    _check_inputs(pack, p1, p2, img)
    if pack.device.type == "cpu":
        return _raster_loss_plain(pack, p1, p2, img, l1, False)[:2]
    if pack.device.type != "cuda":
        raise ValueError(f"unsupported device {pack.device}")
    S, C, _ = _launch(pack, p1, p2, img, l1, False)
    launches["raster_loss"] += 1
    return S, C


def raster_loss_grad_plain(pack, p1, p2, img, l1: bool):
    """K1's plain PyTorch version on any device (the kernel's reference)."""
    _check_inputs(pack, p1, p2, img)
    return _raster_loss_plain(pack, p1, p2, img, l1, True)


def raster_loss_plain(pack, p1, p2, img, l1: bool):
    """K2's plain PyTorch version on any device."""
    _check_inputs(pack, p1, p2, img)
    return _raster_loss_plain(pack, p1, p2, img, l1, False)[:2]


class _RasterLossFn(torch.autograd.Function):
    """(S, C) of the differentiable slot quantities ``gd`` (V,N,6); the
    backward is dg · ∂L/∂S, with dg from the same K1 launch."""

    @staticmethod
    def forward(ctx, gd, aux, p1, p2, img, l1):
        pack = torch.cat([gd, aux], dim=-1).contiguous()
        S, C, dg = raster_loss_grad(pack, p1, p2, img, l1)
        ctx.save_for_backward(dg)
        ctx.mark_non_differentiable(C)
        return S, C

    @staticmethod
    def backward(ctx, gS, gC):
        (dg,) = ctx.saved_tensors
        return dg * gS[:, None, None], None, None, None, None, None


def slot_pack(pp: rasterizer.Preprocessed, prof: ViewProfiles):
    """Depth-sort every view's splats: (gd (V,N,6) differentiable
    [px, py, conic a/b/c, opa], aux (V,N,10) constant [rect, B, spans, 0],
    p1, p2) all in slot order. The stable argsort plus gathers replace the
    TPU's one-hot permutation matmuls."""
    order = rasterizer.depth_order(pp)                       # (V,N)
    opa = torch.where(pp.valid, pp.opacity_eff,
                      torch.zeros_like(pp.opacity_eff))
    gd = torch.cat([pp.pix, pp.conic, opa[..., None]], dim=-1)
    rect = torch.cat([pp.rect_min, pp.rect_max], dim=-1).to(torch.float32)
    aux = torch.cat([rect, prof.B[..., None], prof.spans,
                     torch.zeros_like(prof.B[..., None])], dim=-1)

    def sort(x):
        return torch.take_along_dim(x, order[..., None], dim=-2)

    return (sort(gd), sort(aux).contiguous(), sort(prof.p1).contiguous(),
            sort(prof.p2).contiguous())


def fused_view_loss_cuda(params, cameras, prof: ViewProfiles, W: int, H: int,
                         antialiasing: bool = False,
                         loss_function: str = "l2_gaussian"):
    """(V,) masked heatmap loss S / max(C, 1) of a batch of views through
    the kernel. ``params`` fields are (N,·) or per view (V,N,·); ``cameras``
    and ``prof`` are batched over V."""
    if loss_function not in CUDA_LOSSES:
        raise ValueError(f"cuda kernel does not implement {loss_function!r}")
    l1 = loss_function != "l2_gaussian"
    pp = rasterizer.preprocess_gaussians(
        params.xyz, params.covariance(), params.opacity, cameras, W, H,
        antialiasing)
    gd, aux, p1s, p2s = slot_pack(pp, prof)
    if torch.is_grad_enabled() and gd.requires_grad:
        S, C = _RasterLossFn.apply(gd, aux, p1s, p2s, prof.img, l1)
    else:
        S, C = raster_loss(torch.cat([gd, aux], dim=-1).contiguous(),
                           p1s, p2s, prof.img, l1)
    return S / torch.clamp(C, min=1).to(torch.float32)


def make_cuda_view_loss(model, settings, W: int, H: int,
                        antialiasing: bool = False):
    """Per-view total loss (kernel heatmap term + λ·consistency) with the
    SceneTrainer's (params, cameras, view_aux, poses_2d) signature."""
    cons_fn = loss_registry.consistency_losses[settings.consistency_loss]

    def view_loss(params, cameras, prof, poses_2d):
        main = fused_view_loss_cuda(params, cameras, prof, W, H,
                                    antialiasing, settings.loss_function)
        cons = cons_fn(params.xyz, model.scene_type, reduction="mean")
        return main + cons * settings.lambda_consistency

    return view_loss
