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

On the card a call is two launches: the list of each view's live tiles
(tiles some slot's rect or GT support meets, ``live_tiles_plain`` is its
plain version), then a persistent grid over runs of R consecutive entries
of one view's list that also sums each view's partials; the live-tile
count never reaches the host. ``run_length`` picks R from the call's
shape; the results are bitwise the same for every R.

Each wrapper launches the kernel for CUDA tensors (through
``_build.launch``, which counts it) and runs its plain PyTorch version,
the same two passes over row chunks, for CPU tensors. The trainer's macro
step takes dg back to the parameters by hand (``ops/cuda_preprocess.py``).
``fused_view_loss_cuda`` is the same loss under autograd:
``_RasterLossFn``'s backward is dg scaled by the loss cotangent, and
gradients reach xyz, scales, quats and opacity through autograd of the
preprocess and the depth-order gather.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from skelsplat_tpu_torch import losses as loss_registry
from skelsplat_tpu_torch import tracing
from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.ops import _build
from skelsplat_tpu_torch.ops import heatmaps as hm
from skelsplat_tpu_torch.ops import rasterizer

# Slot record, one per depth-sorted splat (csrc/raster_math.cuh):
# [px, py, conic a, b, c, opa | rect x0, y0, x1, y1 (tiles) | B |
#  GT support rows gy0, gy1 and columns gx0, gx1 (pixels) | unused]
PACK = 16
N_GRAD = 6           # px, py, conic a, b, c, opa
MAX_SLOTS = 32       # the kernel keeps a tile's slots in one 64-bit mask
MAX_RUN = 64         # the tile kernel's longest run of list entries
IDX_PX, IDX_PY, IDX_CA, IDX_CB, IDX_CC, IDX_OPA = range(6)
IDX_RX0, IDX_RY0, IDX_RX1, IDX_RY1, IDX_B = 6, 7, 8, 9, 10
IDX_GY0, IDX_GY1, IDX_GX0, IDX_GX1 = 11, 12, 13, 14

# the losses the tile kernel implements (and ops/fused.py, its autograd
# reference)
CUDA_LOSSES = ("l2_gaussian", "l1_gaussian", "l1_masked")

# the hand-written kernels' launches by label: the tracing counter itself,
# under the name benchmark/skbench/program.py reads
launches = tracing.counters["kernel_launches"]


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
# Plain PyTorch versions of K1 and K2, and of K1's live-tile list
# ---------------------------------------------------------------------------

def tile_flags(pack, H: int, W: int):
    """(rend, gt) (V,N,ty,tx) bool over the 16×16 tiles of an H×W grid:
    slot i's rect covers the tile with opacity > 0 (render work), and its
    GT support [gy0, gy1) × [gx0, gx1) meets the tile (GT terms), by the
    kernel's float compares."""
    V, N, _ = pack.shape
    T = geometry.BLOCK_X
    by = torch.arange(-(-H // T), dtype=torch.float32,
                      device=pack.device).reshape(1, 1, -1, 1)
    bx = torch.arange(-(-W // T), dtype=torch.float32,
                      device=pack.device).reshape(1, 1, 1, -1)
    y0, x0 = by * T, bx * T

    def col(k):
        return pack[:, :, k].reshape(V, N, 1, 1)

    rend = ((col(IDX_OPA) > 0) & (bx >= col(IDX_RX0)) & (bx < col(IDX_RX1))
            & (by >= col(IDX_RY0)) & (by < col(IDX_RY1)))
    gt = ((col(IDX_GY0) < y0 + T) & (col(IDX_GY1) > y0)
          & (col(IDX_GX0) < x0 + T) & (col(IDX_GX1) > x0))
    return rend, gt


def live_tiles_plain(pack, H: int, W: int):
    """K1's live-tile list on any device: (live_idx (V, n_tiles) int32,
    live_mask (V, n_tiles) int64, live_n (V,) int32). A tile (index
    ty·ceil(W/16) + tx) is live when some slot flags it (``tile_flags``);
    view v's live tiles come first in live_idx[v], ascending, with their
    slot masks (bit i: slot i renders there, bit 32 + i: its GT support
    meets it), and -1 and 0 fill the rest."""
    rend, gt = tile_flags(pack, H, W)
    V, N = pack.shape[:2]
    bits = torch.arange(N, dtype=torch.int64, device=pack.device)
    bits = torch.bitwise_left_shift(torch.ones_like(bits), bits)

    def to_mask(f):  # (V,N,ty,tx) -> (V, n_tiles): sum of the set slot bits
        return (f.reshape(V, N, -1).to(torch.int64)
                * bits.reshape(1, N, 1)).sum(dim=1)

    mask = to_mask(rend) | torch.bitwise_left_shift(to_mask(gt), 32)
    live = mask != 0
    live_n = live.sum(dim=1)
    order = torch.argsort((~live).to(torch.uint8), dim=1, stable=True)
    first = (torch.arange(live.shape[1], device=pack.device).reshape(1, -1)
             < live_n.reshape(V, 1))
    live_idx = torch.where(first, order, -1).to(torch.int32)
    live_mask = torch.where(first, torch.take_along_dim(mask, order, dim=1),
                            0)
    return live_idx, live_mask, live_n.to(torch.int32)


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


def run_length(V: int, n_tiles: int, grid: int) -> int:
    """The tile kernel's run length R for a call over ``V`` views of
    ``n_tiles`` tiles each on a persistent grid of ``grid`` blocks.

    A run pays its view's slot records, its list records and its ticket
    once, so long runs suit a call whose blocks each meet many live tiles;
    but a view's runs are the call's units of parallel work, so a call
    with few live tiles a block wants short ones, or blocks sit idle. The
    host never learns the live count, so R follows the tiles a block
    covers, V · n_tiles / grid, by thresholds measured on an H100 (PERF.md
    section 6); the results do not depend on R, only the time."""
    per_block = V * n_tiles / grid
    R = next(R for bound, R in RUN_TABLE if per_block < bound)
    return min(R, n_tiles)    # no list is longer than n_tiles


# (tiles a block covers below which, R), measured at the benchmark's
# calls on the H100's 396 resident blocks of a tile kernel that tested
# every slot: 4 × 1002×1000 (40 tiles a block, ~1.7 live), 4 × 1920×1080
# (82, ~5.5 live) and 512 × 1920×1080 (10,550, ~800 live). The chains take
# the shortest runs that still give each block at most one (a second round
# of runs costs more than a longer run); the batch's runs stop gaining past
# ~48 entries. The kernel that walks the flagged slots alone has 528
# blocks, so the same calls cover 30, 62 and 7,913 tiles a block and take
# the same R.
RUN_TABLE = ((60, 2), (1000, 7), (float("inf"), 48))


@functools.lru_cache(maxsize=None)
def persistent_grid(device_index: int, with_grad: bool, l1: bool,
                    n_slots: int) -> int:
    """Resident blocks of the tile kernel a call with ``n_slots`` slots
    launches, on the whole card: the grid ``run_length`` divides by."""
    per_sm = _build.occupancy(with_grad, l1, _build.slot_bound(
        n_slots, with_grad))["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * per_sm


def _launch(pack, p1, p2, img, l1: bool, with_grad: bool,
            run: int | None = None):
    """One call of the kernel; ``run`` forces the tile kernel's run length
    (default ``run_length`` of the call's shape)."""
    if run is not None and not 1 <= run <= MAX_RUN:
        raise ValueError(f"run length {run} outside 1..{MAX_RUN}")
    V, N, _ = pack.shape
    H, W = p1.shape[-1], p2.shape[-1]
    n_tiles = _build.n_tiles(W, H)
    dev = pack.device
    if run is None:
        run = run_length(V, n_tiles, persistent_grid(dev.index, with_grad,
                                                     l1, N))
    live_idx = torch.empty((V, n_tiles), dtype=torch.int32, device=dev)
    live_mask = torch.empty((V, n_tiles), dtype=torch.int64, device=dev)
    # each view's live count, then its counter of finished runs (the tile
    # kernel's last-block ticket, zeroed by the list kernel)
    counts = torch.empty(2 * V, dtype=torch.int32, device=dev)
    live_n, view_done = counts[:V], counts[V:]
    # partials sized for every tile: the host never learns how many are live
    # (that would be a sync); only the live tiles' are written and read
    part_s = torch.empty(V * n_tiles, dtype=torch.float32, device=dev)
    part_c = torch.empty(V * n_tiles, dtype=torch.int32, device=dev)
    part_dg = torch.empty(V * N * n_tiles * N_GRAD if with_grad else 1,
                          dtype=torch.float32, device=dev)
    S = torch.empty(V, dtype=torch.float32, device=dev)
    C = torch.empty(V, dtype=torch.int32, device=dev)
    dg = torch.empty((V, N, N_GRAD) if with_grad else (1,),
                     dtype=torch.float32, device=dev)
    _build.launch(
        "raster_loss_grad" if with_grad else "raster_loss", dev,
        pack.data_ptr(), p1.data_ptr(), p2.data_ptr(), img.data_ptr(),
        V, N, H, W, int(l1), int(with_grad), run, live_idx.data_ptr(),
        live_mask.data_ptr(), live_n.data_ptr(), view_done.data_ptr(),
        part_s.data_ptr(), part_c.data_ptr(), part_dg.data_ptr(),
        S.data_ptr(), C.data_ptr(), dg.data_ptr())
    if with_grad:
        tracing.count("k1_run_length", str(run))
        tracing.count("k1_slot_bound", str(_build.slot_bound(N)))
    return S, C, (dg if with_grad else None), (live_idx, live_mask, live_n)


def _run(pack, p1, p2, img, l1: bool, with_grad: bool, return_live: bool):
    """(S, C, dg or None) and, with ``return_live``, the live-tile list:
    by the kernel on a CUDA tensor, by the plain versions on a CPU tensor."""
    _check_inputs(pack, p1, p2, img)
    if pack.device.type == "cpu":
        out = _raster_loss_plain(pack, p1, p2, img, l1, with_grad)
        return (*out, live_tiles_plain(pack, p1.shape[-1], p2.shape[-1])) \
            if return_live else out
    if pack.device.type != "cuda":
        raise ValueError(f"unsupported device {pack.device}")
    out = _launch(pack, p1, p2, img, l1, with_grad)
    return out if return_live else out[:3]


def raster_loss_grad(pack, p1, p2, img, l1: bool, return_live: bool = False):
    """K1: (S (V,), C (V,) int32, dg (V,N,6)) of depth-sorted slot records
    ``pack`` (V,N,16) against profiles p1 (V,N,H), p2 (V,N,W) of the same
    slot order and true image sizes ``img`` (V,2). With ``return_live``,
    also the live-tile list the call used (``live_tiles_plain``'s triple;
    on the card only the first live_n[v] entries of a view are set)."""
    return _run(pack, p1, p2, img, l1, True, return_live)


def raster_loss(pack, p1, p2, img, l1: bool, return_live: bool = False):
    """K2: (S (V,), C (V,) int32), pass 1 of K1; with ``return_live``,
    also the live-tile list, as ``raster_loss_grad``."""
    S, C, *rest = _run(pack, p1, p2, img, l1, False, return_live)
    return (S, C, rest[1]) if return_live else (S, C)


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
