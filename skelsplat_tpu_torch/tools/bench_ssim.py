#!/usr/bin/env python
"""SSIM micro-benchmark and agreement check (counterpart of
``skelsplat_tpu/tools/bench_ssim.py``).

    python -m skelsplat_tpu_torch.tools.bench_ssim [--shape 5 1 1080 1920] \
        [--iters 20] [--device cuda|cpu]

On two seeded random images it prints plain ``ssim`` against
``fused_ssim`` (value), the fused backward (the cached-partials
``autograd.Function``) against autograd through the plain ``ssim``
(largest |difference|), and the milliseconds per call of plain ``ssim``,
``fused_ssim`` and the forward + backward of each: by CUDA events over
``--iters`` back-to-back calls, and the summed time of the kernels a call
launches (torch.profiler), after a warm-up call (``tools/timing.py``).
On ``--device cpu`` nothing is timed.
"""

import argparse

import numpy as np
import torch

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.ops import ssim as S
from skelsplat_tpu_torch.tools.timing import cuda_ms

# |fused backward − autograd through the plain SSIM|, element-wise: the
# JAX package's own bar between its two gradients
GRAD_ATOL = 1e-5


def inputs(shape, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.random(shape).astype(np.float32),
                                 device=device) for _ in range(2))


def fused_grad(a, b):
    x = a.detach().requires_grad_(True)
    S.fused_ssim(x, b).backward()
    return x.grad


def plain_grad(a, b):
    x = a.detach().requires_grad_(True)
    S.ssim(x, b).backward()
    return x.grad


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=[5, 1, 1080, 1920])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    a, b = inputs(args.shape, dev)

    with torch.no_grad():
        v_plain, v_fused = float(S.ssim(a, b)), float(S.fused_ssim(a, b))
    g_plain = plain_grad(a, b)
    grad_err = float((fused_grad(a, b) - g_plain).abs().max())
    grad_scale = float(g_plain.abs().max())
    print(f"value agreement: plain {v_plain:.6f} fused {v_fused:.6f} "
          f"diff {abs(v_plain - v_fused):.2e}; gradient: fused backward "
          f"against autograd through plain, largest |difference| "
          f"{grad_err:.2e} (bar {GRAD_ATOL:g}), {grad_err / grad_scale:.2e} "
          f"of the largest |gradient|", flush=True)
    out = {"shape": list(args.shape), "plain": v_plain, "fused": v_fused,
           "grad_max_abs_err": grad_err,
           "grad_rel_err": grad_err / grad_scale}
    if dev.type != "cuda":
        print("times: not measured (CUDA events need the card)")
        return out

    def fwd_plain():
        with torch.no_grad():
            S.ssim(a, b)

    def fwd_fused():
        with torch.no_grad():
            S.fused_ssim(a, b)

    x = a.detach().requires_grad_(True)

    def fwd_bwd_fused():
        x.grad = None
        S.fused_ssim(x, b).backward()

    def fwd_bwd_plain():
        x.grad = None
        S.ssim(x, b).backward()

    for name, fn in (("plain", fwd_plain), ("fused", fwd_fused),
                     ("fused fwd+bwd", fwd_bwd_fused),
                     ("plain fwd+bwd", fwd_bwd_plain)):
        key = name.replace(" ", "_").replace("+", "_")
        per_kernel = {}
        device_ms, ms = cuda_ms(fn, args.iters, warmup=1,
                                per_kernel=per_kernel)
        out[f"{key}_ms"], out[f"{key}_device_ms"] = ms, device_ms
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:3]
        print(f"{name}: {ms:.4f} ms (CUDA events), kernels {device_ms:.4f} "
              f"ms; longest kernels (ms a launch): "
              + "; ".join(f"{k[:60]} {v:.4f}" for k, v in top), flush=True)
    return out


if __name__ == "__main__":
    main()
