"""PLY codec (counterpart of ``skelsplat_tpu/data/ply.py``), numpy only.

PLY files are the framework's interchange format: the per-scene result
clouds ``point_cloud/iteration_{it}/{scene}.ply`` and the ``input.ply`` /
``sparse/points3D.ply`` initial-pose clouds. The writers produce the same
bytes as the JAX package's, so either package's eval reads either's runs:

* ``write_gaussian_ply``: binary_little_endian float32 properties
  x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_*;
* ``write_point_ply``: xyz f4, zero normals f4, rgb u1;
* ``write_xyz_double_ply``: double-precision points;
* ``read_ply`` parses any of them (ascii or binary_little_endian).
"""

from __future__ import annotations

import os

import numpy as np

_PLY_TYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "short": ("<i2", 2), "ushort": ("<u2", 2),
    "char": ("i1", 1),
}


def _mkdir_for(path):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _write_binary(path: str, names: list[str], types: list[str],
                  columns: list[np.ndarray]):
    n = len(columns[0])
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property {t} {nm}" for t, nm in zip(types, names)]
    header += ["end_header"]
    dtype = np.dtype([(nm, _PLY_TYPES[t][0]) for nm, t in zip(names, types)])
    rec = np.empty(n, dtype=dtype)
    for nm, col in zip(names, columns):
        rec[nm] = col
    _mkdir_for(path)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


def gaussian_property_names(n_fdc: int, n_frest: int = 0, n_scale: int = 3,
                            n_rot: int = 4) -> list[str]:
    """Property order of a result cloud."""
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(n_fdc)]
    names += [f"f_rest_{i}" for i in range(n_frest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(n_scale)]
    names += [f"rot_{i}" for i in range(n_rot)]
    return names


def write_gaussian_ply(path: str, xyz, log_scales, quats, opacity_logit,
                       features_dc=None):
    """Write a result cloud in the reference schema: raw (pre-activation)
    values, zero normals,
    one-hot f_dc features (flattened (N,1,C) → C columns)."""
    xyz = np.asarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    if features_dc is None:
        features_dc = np.eye(n, dtype=np.float32)
    features_dc = np.asarray(features_dc, dtype=np.float32).reshape(n, -1)
    log_scales = np.asarray(log_scales, dtype=np.float32)
    quats = np.asarray(quats, dtype=np.float32)
    opacity = np.asarray(opacity_logit, dtype=np.float32).reshape(n)
    names = gaussian_property_names(features_dc.shape[1], 0,
                                    log_scales.shape[1], quats.shape[1])
    cols = ([xyz[:, 0], xyz[:, 1], xyz[:, 2],
             np.zeros(n, np.float32), np.zeros(n, np.float32),
             np.zeros(n, np.float32)]
            + [features_dc[:, i] for i in range(features_dc.shape[1])]
            + [opacity]
            + [log_scales[:, i] for i in range(log_scales.shape[1])]
            + [quats[:, i] for i in range(quats.shape[1])])
    _write_binary(path, names, ["float"] * len(names), cols)


def write_point_ply(path: str, xyz, rgb):
    """An initial-pose cloud: xyz f4, zero normals f4, rgb u1."""
    xyz = np.asarray(xyz, dtype=np.float32)
    rgb = np.asarray(rgb).astype(np.uint8)
    n = xyz.shape[0]
    z = np.zeros(n, np.float32)
    names = ["x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"]
    types = ["float"] * 6 + ["uchar"] * 3
    cols = [xyz[:, 0], xyz[:, 1], xyz[:, 2], z, z, z,
            rgb[:, 0], rgb[:, 1], rgb[:, 2]]
    _write_binary(path, names, types, cols)


def write_xyz_double_ply(path: str, xyz):
    """open3d-style double-precision point cloud (what triangulation.py
    emits for the iteration_0 initial guesses)."""
    xyz = np.asarray(xyz, dtype=np.float64)
    _write_binary(path, ["x", "y", "z"], ["double"] * 3,
                  [xyz[:, 0], xyz[:, 1], xyz[:, 2]])


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Parse a vertex-element PLY (ascii / binary_little_endian) into
    {property: array}."""
    with open(path, "rb") as f:
        # header
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = None
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list properties unsupported")
                props.append((parts[2], parts[1]))
            elif parts[0] == "end_header":
                break
        if fmt == "binary_little_endian":
            dtype = np.dtype([(nm, _PLY_TYPES[t][0]) for nm, t in props])
            rec = np.fromfile(f, dtype=dtype, count=n)
        elif fmt == "ascii":
            data = np.loadtxt(f, max_rows=n, ndmin=2)
            rec = {nm: data[:, i] for i, (nm, _) in enumerate(props)}
            return {nm: np.asarray(rec[nm]) for nm, _ in props}
        else:
            raise ValueError(f"{path}: unsupported format {fmt}")
    return {nm: np.asarray(rec[nm]) for nm, _ in props}


def read_xyz(path: str) -> np.ndarray:
    """(N,3) positions: the eval path's view of a result cloud."""
    d = read_ply(path)
    return np.stack([d["x"], d["y"], d["z"]], axis=1)


def read_gaussian_ply(path: str):
    """Full parameter load of a result cloud: returns
    dict(xyz, log_scales, quats, opacity_logit, features_dc)."""
    d = read_ply(path)
    xyz = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)
    fdc = sorted((k for k in d if k.startswith("f_dc_")),
                 key=lambda s: int(s.split("_")[-1]))
    scl = sorted((k for k in d if k.startswith("scale_")),
                 key=lambda s: int(s.split("_")[-1]))
    rot = sorted((k for k in d if k.startswith("rot_")),
                 key=lambda s: int(s.split("_")[-1]))
    return {
        "xyz": xyz,
        "log_scales": np.stack([d[k] for k in scl], 1).astype(np.float32),
        "quats": np.stack([d[k] for k in rot], 1).astype(np.float32),
        "opacity_logit": d["opacity"].astype(np.float32)[:, None],
        "features_dc": (np.stack([d[k] for k in fdc], 1).astype(np.float32)
                        if fdc else None),
    }
