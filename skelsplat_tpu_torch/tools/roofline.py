"""Roofline accounting for the raster-loss kernel K1 on the card
(counterpart of ``skelsplat_tpu/tools/roofline.py``).

Three ingredients:

1. **Static operation counts**: the f32 operations per (pixel, slot) pair
   that the mathematics needs (``PAIR_OPS``) and that ``csrc/raster_loss.cu``
   issues (``PAIR_OPS_ISSUED``), and per 16×16 tile (``TILE_OPS``), read off
   the source line by line, with ``expf`` in its own column.
2. **Activity** (``tile_activity``): how many pairs and tiles the kernel's
   tile flags make it visit on given inputs, and how many pairs the data
   needs, measured at the initial parameters of a synthetic H36M frame
   through the port's own preprocess and pack
   (``kernel_probe.probe_inputs``).
3. **Measured issue rates** (``--probe``, GPU only): K3,
   ``csrc/issue_rate.cu``, runs dependent chains of mul, fma (FMUL then
   FADD), exp and the 9-operation ``mix`` over a grid that fills every SM,
   with each launch sized to at least a millisecond of device time, at 1, 2
   and 4 interleaved chains a thread (what instruction-level parallelism
   buys). ``mix`` is K1's own kind of instruction stream; ``exp`` gives the
   weight of one accurate ``expf`` in ``mix`` operations.

``kernel_bound`` turns them into two bounds for K1: against the published
peaks (67 TFLOP/s f32 with an FMA counted as 2, 3.35 TB/s), and, when a
probe has run, against the fastest measured ``mix`` rate with ``expf``
weighted by its measured cost. K1's time comes from ``kernel_probe`` in
the same run.

Run:
    python -m skelsplat_tpu_torch.tools.roofline --device cpu  # counts only
    python -m skelsplat_tpu_torch.tools.roofline --probe       # GPU: + rates
"""

from __future__ import annotations

import argparse
import collections
import math
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.core import geometry
from skelsplat_tpu_torch.ops import _build
from skelsplat_tpu_torch.ops import cuda_raster as cr

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s
# and f32 FLOP/s outside the tensor cores, an FMA counted as 2
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# non-fused f32 instructions a second on the same published figures:
# 132 SMs x 128 FP32 lanes x 1.98 GHz boost clock
PEAK_ISSUE_PER_S = 132 * 128 * 1.98e9

# --- f32 operations per (pixel, slot) pair -------------------------------
#
# (operations, expf calls). An add, sub, mul, compare, predicate and/or,
# select, min or max counts 1; a negation folded into an operand counts 0;
# an int<->float conversion, a load or a store is not an f32 operation.
# An IEEE division counts 1 though it is a short sequence (reciprocal and
# refinement), so a total errs low and a bound built on it stays a lower
# bound.
#
# PAIR_OPS is what the mathematics needs, and what the bounds use: pass 1
# once, pass 2's gradient terms on pass 1's values, and one add per pixel
# for each reduced value. PAIR_OPS_ISSUED is what csrc/raster_loss.cu does,
# read off the source line by line: its pass 2 recomputes gt, r, the mask
# and slot_alpha (with a second expf; keeping pass 1's values instead cost
# registers and measured no faster on an H100, PERF.md) and folds the six
# gradient components across the warp with selects as well as adds.
PAIR_OPS = {
    # pass 1, the slot's rect covers the tile (raster_loss_live, pass 1):
    #   gt = in_grid ? p1*p2 + B : 0                       mul add select  3
    #   slot_alpha (raster_math.cuh:39-45): dx dy 2, power 9, opa*E 1,
    #     clamp compare+select 2                                          14
    #   gate: 2 compares, and                                              3
    #   a_i select, 1-a_i, test mul, ge compare, live and, contrib mul
    #     and select, clamp max min                                        9
    #   mask: 2 compares, or, and                                          4
    #   loss: sub, d*d, add to S                                           3
    #   al select, T update 2 selects                                      3
    "pass1_render": (39, 1),
    # pass 1, GT-only: the slot's GT support meets the tile, its rect does
    # not: gt 3; gt > 0 and in_img 2; gt*gt, add 2
    "pass1_gt_only": (7, 0),
    # pass 2 on pass 1's d = r - gt, 1 - a_i, opa*E, a_i*T_i, mask, dx, dy:
    #   ghat = mask & live ? 2d : 0: and, mul, select                      3
    #   dalpha = live ? T_i*ghat - sfx/(1-a_i) : 0: mul, div, sub, select  4
    #   dpower = dalpha*(opa*E)                                            1
    #   six gradient terms 4+4+3+2+3+1                                    17
    #   one add per gradient component into its sum                        6
    #   sfx += (a_i*T_i)*ghat: mul, add                                    2
    "pass2": (33, 0),
}
PAIR_OPS_ISSUED = {
    **PAIR_OPS,
    # pass 2 as raster_loss_live does it: live compare 1; r = clamp(a_i*T_i)
    #   3; gt 3; mask 4; ghat: and, sub, 2d, select 4; slot_alpha dx dy power
    #   11 (its alpha is unused and dead); dalpha: mul, 1-a_i, div, sub,
    #   select 5; opa*E and dpower 2; gradient terms 17; warp_sum6 per lane:
    #   8 shuffle-adds and 12 selects 20; sfx: 2 mul, add 3                73
    "pass2": (73, 1),
}

# --- work outside the pairs (raster_loss.cu) ---------------------------------
TILE_OPS = {
    # live_tiles, per view: for each tile column and slot, opa > 0, the
    # rect's 2 compares and 2 ands, x0 + 16 and the support's 2 compares
    # and an and (9); for each tile row and slot, 2 compares and an and,
    # and the support's 4 (7); per tile one integer AND of two masks
    "list ops per slot and tile column": 9,
    "list ops per slot and tile row": 7,
    # raster_loss_live, per live tile: in_grid/in_img 4 and the S warp sum
    # 5 per lane; 8 adds for S in lane 0 and for each render slot's 6 dg
    # partials; a dead tile costs nothing here
    "live-tile ops per lane": 9,
    "live-tile adds per partial": 8,
}
# and per view the block that finishes its last live tile adds each of
# the view's live tiles' 1 + 6N float partials and its count into one value

OPS = ("mul", "fma", "exp", "mix")
# operations per step of each chain, counted as PAIR_OPS counts them
# (an exp step is counted as 1: its rate is in exp steps a second)
OPS_PER_STEP = {"mul": 1, "fma": 2, "exp": 1, "mix": 9}
UNROLL = 64           # csrc/issue_rate.cu: k_steps is a multiple of this
ISSUE_THREADS = 256   # threads per block of K3
CHAINS = (1, 2, 4)
# the probe: 8 resident blocks of 256 threads per SM (K3 needs <= 19
# registers, so 2048 threads fit), each launch >= 2 ms of device time so
# that launch latency stays out of the rate
PROBE_BLOCKS_PER_SM = 8
PROBE_MS = 2.0


# ---------------------------------------------------------------------------
# K3: the issue-rate chain, kernel and plain version
# ---------------------------------------------------------------------------

def _f32(v: float, device) -> torch.Tensor:
    """A Python double rounded to f32, as the kernel's constants are."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def _steps(device):
    c_mul, c_add, c_scale = (_f32(v, device) for v in (1.0000001, 1e-9, 1e-7))
    half, quarter = _f32(0.5, device), _f32(0.25, device)
    p_max, x_min = _f32(0.26, device), _f32(1e-3, device)

    def mix(x):
        d = x - half
        p = d * d
        q = p * quarter + x * half
        m = (p <= p_max) & (x >= x_min)
        return torch.where(m, q, x)

    return {"mul": lambda x: x * c_mul,
            "fma": lambda x: x * c_mul + c_add,
            "exp": lambda x: torch.exp(x) * c_scale - c_scale,
            "mix": mix}


def _check_issue(x, k_steps: int, chains: int, op: str):
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.dim() != 1 or x.numel() < 1:
        raise ValueError(f"x must be a non-empty 1-D array, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"x has {x.numel()} elements, over the int32 index")
    if k_steps < UNROLL or k_steps % UNROLL or k_steps >= 2 ** 31:
        raise ValueError(f"k_steps={k_steps} must be a positive multiple of "
                         f"{UNROLL} below 2**31")
    if chains not in CHAINS:
        raise ValueError(f"chains={chains} not in {CHAINS}")
    if op not in OPS:
        raise ValueError(f"op {op!r} not in {OPS}")


def issue_rate_plain(x, k_steps: int, chains: int, op: str):
    """K3's plain PyTorch version on any device: the same chains as torch
    ops in the same order, each op rounding on its own."""
    _check_issue(x, k_steps, chains, op)
    step = _steps(x.device)[op]
    xs = [x * _f32(1.0 + 1e-6 * c, x.device) for c in range(chains)]
    for _ in range(k_steps // chains):
        xs = [step(v) for v in xs]
    acc = xs[0]
    for v in xs[1:]:
        acc = acc + v
    return acc


def issue_rate(x, k_steps: int, chains: int, op: str):
    """K3: per element of the flat f32 ``x``, ``chains`` interleaved chains
    that start at x·(1 + 1e-6·c) and together run ``k_steps`` dependent
    steps of ``op`` (k_steps / chains each); returns the chains' sum. The
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    _check_issue(x, k_steps, chains, op)
    if x.device.type == "cpu":
        return issue_rate_plain(x, k_steps, chains, op)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    _build.launch("issue_rate", x.device, x.data_ptr(), out.data_ptr(),
                  x.numel(), k_steps, chains, OPS.index(op))
    return out


def probe_issue_rate(op: str, chains: int = 1) -> dict:
    """K3's rate on the card: PROBE_BLOCKS_PER_SM 256-thread blocks on every
    SM, one element a thread, ``chains`` interleaved chains, with k_steps
    grown until one launch takes PROBE_MS of device time. Returns the
    operations a second (OPS_PER_STEP per step) by device time (profiler
    kernel rows over back-to-back launches) and by CUDA events, with the
    sizes and input."""
    from skelsplat_tpu_torch.tools.timing import cuda_ms

    dev = resolve_device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = sms * PROBE_BLOCKS_PER_SM * ISSUE_THREADS
    x = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, n),
                        dtype=torch.float32, device=dev)
    k = 64 * UNROLL
    issue_rate(x, k, chains, op)     # build and warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):               # grow k until one launch is long enough
        start.record()
        issue_rate(x, k, chains, op)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        if ms >= PROBE_MS:
            break
        k = UNROLL * math.ceil(k * 1.1 * PROBE_MS / ms / UNROLL)
    ms, stream_ms = cuda_ms(lambda: issue_rate(x, k, chains, op), reps=10,
                            warmup=1, each_kernel_once=True)
    if ms < 1.0:
        raise RuntimeError(f"{op}/{chains} probe launch took {ms:.3f} ms, "
                           "under the 1 ms that keeps launch latency out of "
                           "the rate")
    ops = n * k * OPS_PER_STEP[op]
    return {"op": op, "chains": chains, "n": n, "k_steps": k, "x": x, "ms": ms,
            "stream_ms": stream_ms, "rate": ops / (ms * 1e-3),
            "stream_rate": ops / (stream_ms * 1e-3)}


def exp_weight(rates: dict) -> float:
    """Cost of one accurate expf in ``mix`` operations: an exp step's time
    in mix operations, less the step's own mul and sub (roofline.py:297 of
    the JAX package)."""
    return max(rates["mix"] / rates["exp"] - 2.0, 1.0)


def sass_opcodes(lib_path) -> dict:
    """{kernel symbol: Counter of SASS opcodes} of a built library, from
    ``cuobjdump -sass`` (opcode without its modifiers)."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, fn = {}, None
    op_re = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = collections.Counter()
        elif fn is not None:
            m = op_re.search(line)
            if m:
                counts[fn][m.group(1)] += 1
    return counts


# ---------------------------------------------------------------------------
# K1: activity on given inputs, operation counts and bounds
# ---------------------------------------------------------------------------

def tile_activity(pack, img, shape=None) -> dict:
    """What K1's tile flags make it do on depth-sorted slot records ``pack``
    (V,N,16) with true image sizes ``img`` (V,2), over a grid of ``shape``
    (H, W) pixels (default: the largest image). Per view (int64 (V,)):

    * ``render_pairs``: in-image (pixel, slot) pairs whose 16×16 tile the
      slot's rect covers with opacity > 0 (pass 1 and pass 2 work);
    * ``gt_only_pairs``: in-image pairs outside those that lie in the
      slot's nonzero GT span (GT-only terms);
    * ``active_tiles`` (of ``tiles``): tiles with any flagged slot;
    * ``flagged_pairs``: flagged (tile, slot) pairs, split into
      ``render_flagged`` and ``gt_only_flagged``; ``flagged_per_slot``
      (V,N) counts each slot's flagged tiles.
    """
    if pack.dim() != 3 or pack.shape[2] != cr.PACK:
        raise ValueError(f"pack must be (V, N, {cr.PACK}), got {tuple(pack.shape)}")
    V, N, _ = pack.shape
    if img.shape != (V, 2):
        raise ValueError(f"img must be ({V}, 2), got {tuple(img.shape)}")
    if pack.dtype != torch.float32 or img.dtype != torch.float32:
        raise TypeError("pack and img must be float32")
    H, W = shape or (int(img[:, 1].max()), int(img[:, 0].max()))
    dev = pack.device
    T = float(geometry.BLOCK_X)
    ty = torch.arange(-(-H // geometry.BLOCK_Y), dtype=torch.float32,
                      device=dev)
    tx = torch.arange(-(-W // geometry.BLOCK_X), dtype=torch.float32,
                      device=dev)
    ty, tx = ty.reshape(1, 1, -1, 1), tx.reshape(1, 1, 1, -1)
    y0, x0 = ty * T, tx * T

    def col(k):
        return pack[:, :, k].reshape(V, N, 1, 1)

    rend, gtf = cr.tile_flags(pack, H, W)
    flagged = rend | gtf
    # in-image pixel rows [y0, ylim) and columns [x0, xlim) of each tile
    xlim = torch.ceil(torch.clamp(img[:, 0], max=W)).reshape(V, 1, 1, 1)
    ylim = torch.ceil(torch.clamp(img[:, 1], max=H)).reshape(V, 1, 1, 1)
    tile_px = (torch.clamp(torch.minimum(x0 + T, xlim) - x0, min=0)
               * torch.clamp(torch.minimum(y0 + T, ylim) - y0, min=0))
    gt_px = (torch.clamp(torch.minimum(torch.minimum(x0 + T, xlim),
                                       col(cr.IDX_GX1))
                         - torch.maximum(x0, col(cr.IDX_GX0)), min=0)
             * torch.clamp(torch.minimum(torch.minimum(y0 + T, ylim),
                                         col(cr.IDX_GY1))
                           - torch.maximum(y0, col(cr.IDX_GY0)), min=0))

    def per_view(t):
        return t.sum(dim=(1, 2, 3)).to(torch.int64)

    return {
        "render_pairs": per_view(torch.where(rend, tile_px, 0.0)),
        "gt_only_pairs": per_view(torch.where(rend, 0.0, gt_px)),
        "tiles": ty.shape[2] * tx.shape[3],
        "active_tiles": flagged.any(dim=1).sum(dim=(1, 2)).to(torch.int64),
        "flagged_pairs": per_view(flagged),
        "render_flagged": per_view(rend),
        "gt_only_flagged": per_view(gtf & ~rend),
        "flagged_per_slot": flagged.sum(dim=(2, 3)).to(torch.int64),
    }


def pair_work(render_pairs: int, gt_only_pairs: int, with_grad: bool,
              table=PAIR_OPS):
    """(f32 operations, expf calls) of K1 (``with_grad``) or K2 over the
    given pairs, by ``table`` (PAIR_OPS or PAIR_OPS_ISSUED)."""
    p1r, p1g, p2 = (table[k] for k in ("pass1_render", "pass1_gt_only",
                                       "pass2"))
    per_rend = [a + (b if with_grad else 0) for a, b in zip(p1r, p2)]
    return (render_pairs * per_rend[0] + gt_only_pairs * p1g[0],
            render_pairs * per_rend[1] + gt_only_pairs * p1g[1])


def kernel_bound(pack, p1s, p2s, img, with_grad: bool, rates=None,
                 activity=None) -> dict:
    """The least time for K1 (``with_grad``) or K2 on these inputs: the
    larger of its bytes (inputs read once, outputs written once) over the
    HBM rate and its operations (the pairs the data needs, PAIR_OPS) over
    an f32 rate. ``published``: (ms, "bytes"|"operations") against the
    published peaks, expf counted as 1 operation. ``measured``: the same
    against K3's ``mix`` rate with expf weighted by its measured cost, when
    ``rates`` ({op: operations/s}, the fastest over chain counts) come from
    a probe; else None."""
    V, N, _ = pack.shape
    out_floats = 2 * V + (V * N * cr.N_GRAD if with_grad else 0)
    n_bytes = 4 * (pack.numel() + p1s.numel() + p2s.numel() + img.numel()
                   + out_floats)
    act = activity or tile_activity(pack, img, (p1s.shape[-1], p2s.shape[-1]))
    ops, exps = pair_work(int(act["render_pairs"].sum()),
                          int(act["gt_only_pairs"].sum()), with_grad)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3

    def larger(t_ops):
        return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")

    out = {"bytes": n_bytes, "ops": ops, "expf": exps,
           "published": larger((ops + exps) / PEAK_F32_PER_S * 1e3),
           "measured": None, "exp_weight": None}
    if rates is not None:
        w = exp_weight(rates)
        out["exp_weight"] = w
        out["measured"] = larger((ops + exps * w) / rates["mix"] * 1e3)
    return out


def _print_counts(act, N: int, out=print):
    out("f32 operations per (pixel, slot) pair (ops + expf): needed, "
        "and issued by csrc/raster_loss.cu:")
    for k, (ops, exps) in PAIR_OPS.items():
        i_ops, i_exps = PAIR_OPS_ISSUED[k]
        out(f"  {k:<14} {ops:>3} + {exps} expf needed, "
            f"{i_ops:>3} + {i_exps} expf issued")
    out("outside the pairs: " + ", ".join(f"{k} {v}" for k, v in
                                           TILE_OPS.items())
        + f"; a live tile stores {1 + 6 * N} + 1 partials at N = {N}, a "
        f"dead one none")
    out(f"activity per view ({act['tiles']} tiles of 16x16):")
    for v in range(len(act["render_pairs"])):
        out(f"  view {v}: {int(act['render_pairs'][v])} render pairs, "
            f"{int(act['gt_only_pairs'][v])} GT-only pairs; "
            f"{int(act['active_tiles'][v])} active tiles; "
            f"{int(act['flagged_pairs'][v])} flagged (tile, slot) pairs "
            f"({int(act['render_flagged'][v])} render, "
            f"{int(act['gt_only_flagged'][v])} GT-only)")


def main(argv=None) -> dict:
    from skelsplat_tpu_torch.tools import kernel_probe

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="store_true",
                    help="measure K3's issue rates and K1's time on the GPU")
    ap.add_argument("--device", default="cuda",
                    help="where the inputs are built (default cuda; "
                         "--probe needs cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.probe and dev.type != "cuda":
        raise RuntimeError("--probe times kernels on the GPU; it cannot run "
                           f"on {dev}")
    pack, p1s, p2s, img = kernel_probe.probe_inputs(device=dev)
    V, N, _ = pack.shape
    act = tile_activity(pack, img, (p1s.shape[-1], p2s.shape[-1]))
    _print_counts(act, N)
    result = {"activity": act, "rates": None, "k1_ms": None}
    visited = pair_work(256 * int(act["render_flagged"].sum()),
                        256 * int(act["gt_only_flagged"].sum()), True,
                        PAIR_OPS_ISSUED)
    if args.probe:
        from skelsplat_tpu_torch.tools.timing import card_line

        card = card_line()
        probes = [probe_issue_rate(op, c) for op in OPS for c in CHAINS]
        rate = {(p["op"], p["chains"]): p["rate"] for p in probes}
        rates = {op: max(rate[op, c] for c in CHAINS) for op in OPS}
        for p in probes:
            op = p["op"]
            print(f"K3 {op}/{p['chains']}: {p['rate']:.4e} operations/s "
                  f"({p['stream_rate']:.4e} by CUDA events; "
                  f"{p['ms']:.3f} ms/launch, {p['n']} elements x "
                  f"{p['k_steps']} steps)"
                  + ("" if op == "exp" else
                     f" = {p['rate'] / PEAK_F32_PER_S:.3f} of 67e12, "
                     f"{p['rate'] / PEAK_ISSUE_PER_S:.3f} of "
                     f"{PEAK_ISSUE_PER_S:.4g}") + f" on {card}")
        print("  4 chains over 1: " + ", ".join(
            f"{op} {rate[op, 4] / rate[op, 1]:.3f}" for op in OPS))
        print(f"  fastest: fma step = {rates['mul'] / rates['fma'] * 2:.2f} "
              f"mul instructions; expf = {exp_weight(rates):.2f} mix "
              f"operations")
        k1_ms, k1_stream = kernel_probe.time_k1(pack, p1s, p2s, img)
        result.update(rates=rates, probes=probes, k1_ms=k1_ms, card=card)
        print(f"K1 measured: {k1_ms:.4f} ms/launch device time "
              f"({k1_stream:.4f} back to back) on {card}")
    else:
        rates = None
    bound = kernel_bound(pack, p1s, p2s, img, True, rates, act)
    result["bound"] = bound
    print(f"K1 work the data needs: {bound['ops']:,} f32 operations + "
          f"{bound['expf']:,} expf, {bound['bytes']:,} bytes; what the kernel "
          f"issues on the pairs it visits: {visited[0]:,} + {visited[1]:,} "
          f"expf")
    ms, by = bound["published"]
    print(f"K1 bound against the published peaks (67e12 f32, 3.35e12 B/s): "
          f"{ms:.6f} ms by {by}")
    if rates is not None:
        ms_m, by_m = bound["measured"]
        t_visit = (visited[0] + visited[1] * bound["exp_weight"]) \
            / rates["mix"] * 1e3
        result["visited_ms"] = t_visit
        print(f"K1 bound against the measured mix rate (expf = "
              f"{bound['exp_weight']:.2f}): {ms_m:.6f} ms by {by_m}; what "
              f"it issues on the visited pairs, at that rate, "
              f"{t_visit:.6f} ms; K1 takes "
              f"{result['k1_ms'] / ms_m:.0f}x its measured-rate bound, on "
              f"{result['card']}")
    else:
        print("no issue rate: run with --probe on the GPU for the measured "
              "rate bound")
    return result


if __name__ == "__main__":
    main()
