"""Builds the CUDA kernels with nvcc at first use and binds them with ctypes.

The sources in ``csrc/`` compile into one shared library with a plain C
interface under ``<repo>/build/kernels/`` (listed in .gitignore), named by
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. Building needs ``nvcc`` (CUDA_HOME, then PATH,
then /usr/local/cuda) and an sm_90 card: the kernels are compiled for
``sm_90a`` only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("raster_loss.cu",)
HEADERS = ("raster_math.cuh",)
TILE = 16
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

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


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists."""
    global build_log, build_seconds
    import time

    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, out)   # atomic: concurrent builders never see a partial file
    return out


def load_library() -> ctypes.CDLL:
    """The built kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            import torch

            major, minor = torch.cuda.get_device_capability()
            if (major, minor) != (9, 0):
                raise RuntimeError(
                    f"kernels are built for sm_90a; this card is "
                    f"sm_{major}{minor} ({torch.cuda.get_device_name()})")
            lib = ctypes.CDLL(str(build()))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.skelsplat_raster_loss.argtypes = (
                [vp] * 4 + [i32] * 6 + [vp] * 6)
            lib.skelsplat_raster_loss.restype = i32
            lib.skelsplat_error_string.argtypes = [i32]
            lib.skelsplat_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def error_string(err: int) -> str:
    return load_library().skelsplat_error_string(err).decode()
