"""Builds the CUDA kernels with nvcc at first use and binds them with ctypes.

The sources in ``csrc/`` compile into one shared library with a plain C
interface under ``<repo>/build/kernels/`` (listed in .gitignore), named by
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. Each source compiles in its own nvcc process, all
started together, and one more links them. Building needs ``nvcc``
(CUDA_HOME, then PATH, then /usr/local/cuda) and an sm_90 card: the kernels
are compiled for ``sm_90a`` only.

Every kernel the wrappers launch goes through ``launch``, which counts it
under its label in the ``tracing`` counter ``kernel_launches``;
``launch_counts`` reads that counter. A new kernel needs its source in
``SOURCES``, its C entry point's argument types in ``ENTRIES``, its label
in ``KERNELS`` and a wrapper that calls ``launch``.

    python -m skelsplat_tpu_torch.ops._build

times a build from scratch with the compiles one after another and all at
once, in the order serial, parallel, parallel, serial.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from skelsplat_tpu_torch import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("raster_loss.cu", "issue_rate.cu", "preprocess.cu",
           "compose_adam.cu")
HEADERS = ("raster_math.cuh",)
TILE = 16
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_vp, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points' argument types; each returns a cudaError_t as int32,
# and a kernel's entry point takes its stream last
ENTRIES = {
    "skelsplat_raster_loss": [_vp] * 4 + [_i32] * 7 + [_vp] * 11,
    "skelsplat_raster_loss_occupancy": [_i32] * 3 + [_vp],
    "skelsplat_raster_loss_slot_bound": [_i32, _i32],
    "skelsplat_preprocess_pack": [_vp] * 16 + [_i32] * 7 + [_vp] * 5,
    "skelsplat_preprocess_grad": ([_vp] * 16 + [_i32] * 15 + [_f32]
                                  + [_vp] * 6),
    "skelsplat_compose_adam": ([_vp] * 24 + [_i32] * 4 + [_f32] * 2
                               + [_i32] * 2 + [_f32] * 11 + [_vp]),
    "skelsplat_issue_rate": [_vp, _vp] + [_i32] * 4 + [_vp],
}
# each kernel's label (its count in kernel_launches and its profiler range
# skelsplat::<label>) and its entry point: K1 and K2 share theirs
KERNELS = {"raster_loss_grad": "skelsplat_raster_loss",
           "raster_loss": "skelsplat_raster_loss",
           "preprocess_pack": "skelsplat_preprocess_pack",
           "preprocess_grad": "skelsplat_preprocess_grad",
           "compose_adam": "skelsplat_compose_adam",
           "issue_rate": "skelsplat_issue_rate"}

_lock = threading.Lock()
_lib = None
build_log = ""        # nvcc's output of the build this process made
build_seconds = None  # wall time of that build (None when reused)


def n_tiles(W: int, H: int) -> int:
    """16×16 tiles the kernel's grid covers per view."""
    return -(-W // TILE) * -(-H // TILE)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libskelsplat_kernels-{h.hexdigest()[:16]}.so"


def _run(cmds, parallel: bool) -> list[tuple[int, str]]:
    """(return code, output) of each command: all started together, or
    each after the last has ended."""
    if not parallel:
        return [_run([c], True)[0] for c in cmds]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def build(out: Path | None = None, parallel: bool = True) -> Path:
    """Compile the kernels into ``out`` (default ``library_path()``) unless
    it exists, with one nvcc per source: all at once, or with ``parallel``
    false one after another."""
    global build_log, build_seconds
    import time

    out = out or library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, f"{s}.o") for s in SOURCES]
        compiles = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", o,
                     str(CSRC / s)] for s, o in zip(SOURCES, objs)]
        results = _run(compiles, parallel)
        build_log = "".join(log for _, log in results)
        for cmd, (rc, log) in zip(compiles, results):
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        tmp = os.path.join(work, "lib.so")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{build_log}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    build_seconds = time.perf_counter() - t0
    return out


def load_library() -> ctypes.CDLL:
    """The built kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            major, minor = torch.cuda.get_device_capability()
            if (major, minor) != (9, 0):
                raise RuntimeError(
                    f"kernels are built for sm_90a; this card is "
                    f"sm_{major}{minor} ({torch.cuda.get_device_name()})")
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, _i32
            lib.skelsplat_error_string.argtypes = [_i32]
            lib.skelsplat_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def error_string(err: int) -> str:
    return load_library().skelsplat_error_string(err).decode()


def check_launch(rc: int, name: str):
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{error_string(rc)} (cudaError {rc})")


def launch(label: str, device: torch.device, *args) -> None:
    """Launch kernel ``label`` (``KERNELS``) with ``args`` on the current
    stream of CUDA ``device``, inside the profiler range
    ``skelsplat::<label>``; raise if it fails, and count it."""
    lib = load_library()
    with torch.cuda.device(device), \
            tracing.profiler_range(f"skelsplat::{label}"):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, KERNELS[label])(*args, ctypes.c_void_p(stream))
    check_launch(rc, label)
    tracing.count("kernel_launches", label)


def launch_counts(since: dict | None = None) -> dict:
    """Each kernel's launches in this process, by label, 0 for a kernel
    not launched yet; with ``since``, those made after it was read."""
    counts = tracing.counters["kernel_launches"]
    return {k: counts[k] - (since[k] if since else 0) for k in KERNELS}


def occupancy(with_grad: bool, l1: bool, slot_bound: int) -> dict:
    """Registers and local (spill) bytes per thread, and resident blocks per
    SM, of the raster-loss tile kernel instantiated for (with_grad, l1,
    slot_bound): 16, 24 or 32 with a gradient, 32 without."""
    out = (ctypes.c_int * 3)()
    rc = load_library().skelsplat_raster_loss_occupancy(
        int(with_grad), int(l1), slot_bound, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: {error_string(rc)}")
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2]}


def slot_bound(n_slots: int, with_grad: bool = True) -> int:
    """The slot bound of the tile kernel instantiation a call with
    ``n_slots`` slots launches."""
    return load_library().skelsplat_raster_loss_slot_bound(n_slots,
                                                            int(with_grad))


def main(argv=None) -> dict:
    """Seconds of a build from scratch, serial and parallel, alternated."""
    argparse.ArgumentParser(description=main.__doc__).parse_args(argv)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    times = {False: [], True: []}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        for i, parallel in enumerate((False, True, True, False)):
            build(Path(d) / f"lib{i}.so", parallel)
            times[parallel].append(build_seconds)
            print(f"{'parallel' if parallel else 'serial'} build of "
                  f"{len(SOURCES)} sources: {build_seconds:.2f} s", flush=True)
    return {"serial": times[False], "parallel": times[True]}


if __name__ == "__main__":
    main()
