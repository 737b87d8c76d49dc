"""The native PLY codec and Morton kNN (``csrc/ply_codec.cpp``) through
ctypes: the counterpart of ``skelsplat_tpu/native/``.

The library is built at first use with the host C++ compiler (``$CXX``,
else ``g++``, else ``c++``) into ``<repo>/build/native/`` (listed in
.gitignore), named by a hash of the source, the flags, the compiler's
version and the host's C library, so each host builds its own and an
unchanged source is reused. A failed build raises with the compiler's
output.

API:
  read_xyz(path)                 → (N,3) float32
  read_xyz_batch(paths, max_pts) → (F, max_pts, 3) xyz, (F,) counts
  knn_mean3_sq(points)           → (N,) mean of squared 3-NN distances
  available()                    → bool
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from skelsplat_tpu_torch.data import ply

SOURCE = Path(__file__).resolve().parent / "csrc" / "ply_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread"]

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no C++ compiler found (set CXX or put g++ on PATH); "
                       f"the PLY codec is built from {SOURCE} at first use")


def library_path(cxx: str) -> Path:
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[:1]
    h = hashlib.sha256(" ".join(CXX_FLAGS + version).encode())
    h.update(" ".join(platform.libc_ver() + (platform.machine(),)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libskelsplat_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the codec unless this host's library exists."""
    cxx = _compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, "lib.so")
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"C++ build of the PLY codec failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def load() -> ctypes.CDLL:
    """The codec library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
            lib.skel_read_ply_xyz.restype = i64
            lib.skel_read_ply_xyz.argtypes = [ctypes.c_char_p, f32p, i64]
            lib.skel_read_ply_xyz_batch.restype = None
            lib.skel_read_ply_xyz_batch.argtypes = [
                ctypes.c_char_p, i64, f32p, i64, ctypes.POINTER(i64),
                ctypes.c_int]
            lib.skel_knn_mean3_sq.restype = None
            lib.skel_knn_mean3_sq.argtypes = [f32p, i64, f32p]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library loads (building it if need be)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_xyz(path: str, max_pts: int = 4096) -> np.ndarray:
    """(N,3) float32 positions of one PLY; a header the codec does not
    parse (an unusual spacing in a header line, say) goes to the numpy
    reader."""
    out = np.empty((max_pts, 3), np.float32)
    n = load().skel_read_ply_xyz(os.fsencode(path), _f32p(out), max_pts)
    if n < 0:
        return ply.read_xyz(path)
    return out[:n].copy()


def read_xyz_batch(paths: list[str], max_pts: int = 64,
                   n_threads: int = 0):
    """Threaded bulk read, the eval sweep's hot path (thousands of
    ~20-point clouds). Returns ((F, max_pts, 3) xyz, (F,) counts); a
    count is negative where that file did not parse."""
    lib = load()
    blob = b"".join(os.fsencode(p) + b"\x00" for p in paths)
    out = np.zeros((len(paths), max_pts, 3), np.float32)
    counts = np.zeros(len(paths), np.int64)
    lib.skel_read_ply_xyz_batch(
        blob, len(paths), _f32p(out), max_pts,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_threads)
    return out, counts


def knn_mean3_sq(points: np.ndarray) -> np.ndarray:
    """(N,) mean of the squared distances to the 3 nearest neighbours,
    simple-knn's distCUDA2 on the host (Morton-boxed exact search)."""
    pts = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
    out = np.empty(pts.shape[0], np.float32)
    load().skel_knn_mean3_sq(_f32p(pts), pts.shape[0], _f32p(out))
    return out
