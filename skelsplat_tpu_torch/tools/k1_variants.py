"""K1 against other builds of its source, timed side by side on one card.

Builds ``csrc/raster_loss.cu`` of this tree and every other source named
on the command line, each alone into a library of its own under
``build/k1_variants/`` (with the tree's nvcc flags, ``ops/_build.py``),
and calls each through its C entry point at the benchmark cells' K1 calls
(``CELLS``: frame 0 of seeds ``--seed`` .. at its initial parameters, one
seed a scene). For every build and run length it prints the device time a
call of the tile kernel ``raster_loss_live`` and of the list kernel
``live_tiles`` (``timing.cuda_ms``, two readings: the builds in order,
then in reverse), the call's list entries, and whether S, C and dg (and
K2's S and C) are bitwise those of this tree's kernel at its own run
length (``cuda_raster.raster_loss_grad``).

``--build NAME=FILE`` adds FILE as build NAME, say the kernel of an older
commit (``git show <commit>:skelsplat_tpu_torch/csrc/raster_loss.cu >
build/k1_before.cu``). A source whose C entry point takes no run length
is timed once a call shape.

Each build's tile kernel (K1, l2, at the cells' slot bound) is reported
with its registers, local (spill and array) bytes a thread and resident
blocks per SM.

``--slots`` prints, in place of any timing and without a card, how many
slots the live list entries of each cell's call flag (``slot_counts``),
from the inputs made on the CPU: the length of K1's slot walk.

``--split FILE`` adds FILE as build ``before`` and the entry split of its
tile kernel, FILE being the kernel that takes one list entry at a time
(before runs of entries): each variant takes one part of an entry's fixed
cost away, so its outputs differ:

* ``no_sum``: the per-view ticket kept, the view's sum (``reduce_view``)
  skipped;
* ``no_ticket``: no ticket (its fence, atomic and barriers) and so no sum;
* ``pack_once``: the view's slot pack staged at a block's first entry only;
* ``rows_once``: the entry's profile rows staged at a block's first entry
  only;
* ``bare``: ``no_ticket``, ``pack_once`` and ``rows_once`` together.

Usage, on a machine with an H100:
    python -m skelsplat_tpu_torch.tools.k1_variants [--cells NAME ...]
        [--runs R ...] [--build NAME=FILE ...] [--split FILE] [--seed S]
        [--out FILE] [--slots]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.ops import _build, cuda_raster as cr

# the benchmark cells' K1 calls: (cell, W, H, joints, scenes)
CELLS = (("h36m.chain32", 1002, 1000, 17, 1),
         ("panoptic.chain32", 1920, 1080, 19, 1),
         ("panoptic.batch128", 1920, 1080, 19, 128))
OUT_DIR = _build.BUILD_DIR.parent / "k1_variants"

# the single-entry tile kernel's parts that the split takes away
_TICKET = """    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicAdd(&view_done[v], 1u) + 1u == (unsigned)live_n[v];
    __syncthreads();
    if (s_last) {"""
_PACK = ("    for (int q = threadIdx.x; q < N * PACK; q += THREADS) "
         "s_pack[q] = pk[q];")
_ROWS = ("    for (int q = threadIdx.x; q < N * TILE; q += THREADS) {\n"
         "      const int i = q / TILE, o = q % TILE;")
_FIRST = "    if (k == blockIdx.x)\n"
SPLIT = {
    "no_sum": [(_TICKET, _TICKET.replace("if (s_last) {",
                                         "if (s_last && V < 0) {"))],
    "no_ticket": [(_TICKET, "    if (false) {")],
    "pack_once": [(_PACK, _FIRST + _PACK)],
    "rows_once": [(_ROWS, _FIRST + _ROWS)],
}
SPLIT["bare"] = SPLIT["no_ticket"] + SPLIT["pack_once"] + SPLIT["rows_once"]


def takes_run(src: str) -> bool:
    """Whether the source's C entry point takes the tile kernel's run
    length (after ``with_grad``)."""
    return re.search(r"int with_grad,\s*int run,", src) is not None


def patched(src: str, pairs) -> str:
    """``src`` with each (old, new) text replaced; raises ValueError when
    an old text is not in it."""
    for old, new in pairs:
        if old not in src:
            raise ValueError("the source lacks the single-entry tile "
                             f"kernel's text {old.splitlines()[0].strip()!r}")
        src = src.replace(old, new)
    return src


def split_sources(src: str) -> dict:
    """The entry split of the single-entry tile kernel in ``src``."""
    return {"before": src, **{name: patched(src, pairs)
                              for name, pairs in SPLIT.items()}}


def build(name: str, src: str) -> Path:
    """``src`` compiled alone into ``OUT_DIR/lib<name>.so``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"lib{name}.so"
    cu.write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
           str(_build.CSRC), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return so


class Call:
    """One build's K1 (or K2) calls on a cell's inputs, into the buffers of
    ``bufs``, which every build of a cell shares."""

    def __init__(self, so: Path, with_run: bool, x, bufs, with_grad=True):
        self.lib = ctypes.CDLL(str(so))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        self.lib.skelsplat_raster_loss.argtypes = (
            [vp] * 4 + [i32] * (7 if with_run else 6) + [vp] * 11)
        self.lib.skelsplat_raster_loss.restype = i32
        self.with_run, self.x, self.b, self.with_grad = (with_run, x, bufs,
                                                         with_grad)

    def __call__(self, run: int = 1):
        pack, p1, p2, img = self.x
        V, N, _ = pack.shape
        b = self.b
        args = [pack.data_ptr(), p1.data_ptr(), p2.data_ptr(), img.data_ptr(),
                V, N, p1.shape[-1], p2.shape[-1], 0, int(self.with_grad)]
        if self.with_run:
            args.append(run)
        args += [b["live_idx"].data_ptr(), b["live_mask"].data_ptr(),
                 b["counts"].data_ptr(), b["counts"][V:].data_ptr(),
                 b["part_s"].data_ptr(), b["part_c"].data_ptr(),
                 b["part_dg"].data_ptr(), b["S"].data_ptr(),
                 b["C"].data_ptr(), b["dg"].data_ptr(),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]
        _build.check_launch(self.lib.skelsplat_raster_loss(*args), "K1")

    def outputs(self):
        b = self.b
        if self.with_grad:
            return b["S"].clone(), b["C"].clone(), b["dg"].clone()
        return b["S"].clone(), b["C"].clone()


def buffers(x) -> dict:
    """A call's list, partial and output buffers, sized as
    ``cuda_raster._launch`` sizes them."""
    pack, p1, p2, _ = x
    V, N, _ = pack.shape
    nt, dev = _build.n_tiles(p2.shape[-1], p1.shape[-1]), pack.device
    f32, i32 = torch.float32, torch.int32
    return {"live_idx": torch.empty(V * nt, dtype=i32, device=dev),
            "live_mask": torch.empty(V * nt, dtype=torch.int64, device=dev),
            "counts": torch.empty(2 * V, dtype=i32, device=dev),
            "part_s": torch.empty(V * nt, dtype=f32, device=dev),
            "part_c": torch.empty(V * nt, dtype=i32, device=dev),
            "part_dg": torch.empty(V * N * nt * cr.N_GRAD, dtype=f32,
                                   device=dev),
            "S": torch.empty(V, dtype=f32, device=dev),
            "C": torch.empty(V, dtype=i32, device=dev),
            "dg": torch.empty((V, N, cr.N_GRAD), dtype=f32, device=dev)}


def poison(bufs):
    """NaN in S and dg and -1 in C, so that a build that leaves an output
    unwritten reads as not bitwise (the builds share the buffers)."""
    bufs["S"].fill_(float("nan"))
    bufs["dg"].fill_(float("nan"))
    bufs["C"].fill_(-1)


def cell_inputs(width: int, height: int, n_joints: int, scenes: int,
                seed: int = 0, device="cuda"):
    """K1's inputs at a cell's call: frame 0 of seeds ``seed`` ..
    ``seed + scenes - 1`` at its initial parameters, each scene's 4 views
    one scene after another."""
    from skelsplat_tpu_torch.tools.kernel_probe import probe_inputs

    parts = [probe_inputs(width, height, n_joints=n_joints, seed=seed + s,
                          device=device) for s in range(scenes)]
    return tuple(torch.cat(xs).contiguous() for xs in zip(*parts))


def slot_counts(pack, H: int, W: int) -> dict:
    """Histograms over the live list entries of K1's call on ``pack``
    (``cuda_raster.live_tiles_plain``): ``flagged[k]`` entries flag k slots
    (render or GT), ``render[k]`` entries flag k render slots; with the
    entries and the share of them that flag no render slot."""
    _, mask, live_n = cr.live_tiles_plain(pack, H, W)
    N = pack.shape[1]
    live = torch.arange(mask.shape[1], device=mask.device) < live_n[:, None]
    m = mask[live]
    rend = m & 0xFFFFFFFF
    bit = torch.arange(N, device=m.device)

    def hist(x):  # entries by the count of slot bits 0..N-1 set in x
        n = ((x[:, None] >> bit) & 1).sum(dim=1)
        return torch.bincount(n, minlength=N + 1).tolist()

    entries = int(live_n.sum())
    render = hist(rend)
    return {"entries": entries, "flagged": hist(rend | (m >> 32)),
            "render": render,
            "no_render_share": render[0] / entries if entries else 0.0}


def _summary(hist) -> str:
    total = sum(hist)
    mean = sum(k * c for k, c in enumerate(hist)) / max(total, 1)
    top = max((k for k, c in enumerate(hist) if c), default=0)
    return f"mean {mean:.3f}, max {top}"


def cell_slots(cell, seed: int) -> dict:
    """``slot_counts`` of a cell's call, summed scene by scene, from inputs
    made on the CPU."""
    name, w, h, n, scenes = cell
    out = {"cell": name, "views": 4 * scenes, "entries": 0,
           "flagged": [0] * (n + 1), "render": [0] * (n + 1)}
    for s in range(scenes):
        c = slot_counts(cell_inputs(w, h, n, 1, seed + s, device="cpu")[0],
                        h, w)
        out["entries"] += c["entries"]
        for key in ("flagged", "render"):
            out[key] = [a + b for a, b in zip(out[key], c[key])]
    out["no_render_share"] = out["render"][0] / max(out["entries"], 1)
    print(f"{name}: {out['entries'] / out['views']:.1f} entries a view; "
          f"slots flagged an entry {_summary(out['flagged'])}; render slots "
          f"{_summary(out['render'])}; {out['no_render_share']:.3f} of "
          f"entries with no render slot; flagged {out['flagged']}, render "
          f"{out['render']}", flush=True)
    return out


def occupancy(so: Path, n_slots: int) -> dict:
    """Registers, local bytes a thread and resident blocks per SM of the K1
    (l2) tile kernel that library ``so`` launches for ``n_slots`` slots."""
    lib = ctypes.CDLL(str(so))
    for name in ("skelsplat_raster_loss_slot_bound",
                 "skelsplat_raster_loss_occupancy"):
        getattr(lib, name).argtypes = _build.ENTRIES[name]
    ns = lib.skelsplat_raster_loss_slot_bound(n_slots, 1)
    out = (ctypes.c_int * 3)()
    _build.check_launch(lib.skelsplat_raster_loss_occupancy(
        1, 0, ns, ctypes.addressof(out)), "K1 occupancy")
    return {"slot_bound": ns, "registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2]}


def _same(a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a, b))


def measure_cell(cell, libs: dict, runs, seed: int) -> list:
    """Rows of (build, R): the tile and list kernels' device ms in both
    orders, and bitwise against the tree's own call."""
    from skelsplat_tpu_torch.tools.timing import cuda_ms

    name, w, h, n, scenes = cell
    x = cell_inputs(w, h, n, scenes, seed)
    V = x[0].shape[0]
    own = cr.run_length(V, _build.n_tiles(w, h), cr.persistent_grid(
        torch.cuda.current_device(), True, False, n))
    ref = cr.raster_loss_grad(*x, False)
    ref2 = cr.raster_loss(*x, False)
    bufs = buffers(x)
    calls = {b: Call(so, with_run, x, bufs) for b, (so, with_run)
             in libs.items()}
    configs = [(b, R) for b, c in calls.items()
               for R in (sorted({*runs, own}) if c.with_run else [None])]
    reps = 20 if scenes > 1 else 200
    times = {c: [] for c in configs}
    for order in (configs, configs[::-1]):
        for b, R in order:
            per = {}
            cuda_ms(lambda: calls[b](R or 1), reps=reps,
                    each_kernel_once=True, per_kernel=per)
            times[(b, R)].append(
                {k: sum(t for kernel, t in per.items() if k in kernel)
                 for k in ("raster_loss_live", "live_tiles")})
    rows = []
    for b, R in configs:
        poison(bufs)
        calls[b](R or 1)
        torch.cuda.synchronize()
        got, entries = calls[b].outputs(), int(bufs["counts"][:V].sum())
        k2 = Call(libs[b][0], libs[b][1], x, bufs, with_grad=False)
        poison(bufs)
        k2(R or 1)
        torch.cuda.synchronize()
        row = {"cell": name, "build": b, "R": R, "views": V,
               "entries": entries,
               "tile_ms": [t["raster_loss_live"] for t in times[(b, R)]],
               "live_tiles_ms": [t["live_tiles"] for t in times[(b, R)]],
               "bitwise": _same(got, ref), "k2_bitwise": _same(k2.outputs(),
                                                               ref2)}
        rows.append(row)
        print(f"{name} {b} R={R} (tree's own {own}): {entries} entries; "
              f"raster_loss_live "
              f"{', '.join(f'{t * 1e3:.2f}' for t in row['tile_ms'])} us, "
              f"live_tiles "
              f"{', '.join(f'{t * 1e3:.2f}' for t in row['live_tiles_ms'])} "
              f"us; bitwise {row['bitwise']}, K2 {row['k2_bitwise']}",
              flush=True)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", default=[c[0] for c in CELLS],
                    choices=[c[0] for c in CELLS])
    ap.add_argument("--runs", type=int, nargs="+", default=[1],
                    help="run lengths to time each build that takes one at, "
                         "beside the tree's own at each cell")
    ap.add_argument("--build", action="append", default=[],
                    metavar="NAME=FILE", help="another source to time")
    ap.add_argument("--split", metavar="FILE",
                    help="the single-entry kernel to split")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the result here as JSON")
    ap.add_argument("--slots", action="store_true",
                    help="print the slots each cell's list entries flag "
                         "instead (on the CPU)")
    args = ap.parse_args(argv)
    if args.slots:
        out = {"slots": [cell_slots(cell, args.seed) for cell in CELLS
                         if cell[0] in args.cells]}
        print(json.dumps(out), flush=True)
        return out
    resolve_device("cuda")
    from skelsplat_tpu_torch.tools.timing import card_line

    srcs = {"tree": (_build.CSRC / "raster_loss.cu").read_text()}
    for spec in args.build:
        name, _, path = spec.partition("=")
        srcs[name] = Path(path).read_text()
    if args.split:
        srcs.update(split_sources(Path(args.split).read_text()))
    with ThreadPoolExecutor(len(srcs)) as ex:
        sos = dict(zip(srcs, ex.map(build, srcs, srcs.values())))
    libs = {b: (sos[b], takes_run(srcs[b])) for b in srcs}
    out = {"card": card_line(), "rows": [], "occupancy": {}}
    print(f"card: {out['card']}; builds {list(libs)}", flush=True)
    for b, (so, _) in libs.items():
        for n in sorted({cell[3] for cell in CELLS}):
            occ = occupancy(so, n)
            out["occupancy"][f"{b}.n{n}"] = occ
            print(f"{b}, {n} slots: slot bound {occ['slot_bound']}, "
                  f"{occ['registers']} registers, {occ['local_bytes']} local "
                  f"bytes a thread, {occ['blocks_per_sm']} resident blocks "
                  f"per SM", flush=True)
    for cell in CELLS:
        if cell[0] in args.cells:
            out["rows"] += measure_cell(cell, libs, args.runs, args.seed)
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
