"""The JAX package's remaining public names against their counterparts in
the port, on seeded numpy inputs; and the name diff of the two packages,
which leaves only the names the port declines, each with its reason."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skelsplat_tpu.core import cameras as jcameras
from skelsplat_tpu.core import gaussians as jgaussians
from skelsplat_tpu.core import geometry as jg
from skelsplat_tpu.data import cameras_io as jcio
from skelsplat_tpu.engine import optim as joptim
from skelsplat_tpu.engine import trainer as jtrainer
from skelsplat_tpu.ops import fused as jfused
from skelsplat_tpu_torch.core import cameras as tcameras
from skelsplat_tpu_torch.core import gaussians as tgaussians
from skelsplat_tpu_torch.core import geometry as tg
from skelsplat_tpu_torch.data import cameras_io as tcio
from skelsplat_tpu_torch.engine import optim as toptim
from skelsplat_tpu_torch.engine import trainer as ttrainer
from skelsplat_tpu_torch.ops import fused as tfused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-6


def _close(port, ref, rel=REL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= rel * max(np.abs(ref).max(), 1e-30)


def _camera(rng, width=1002, height=1000):
    th = rng.uniform(0, 2 * np.pi)
    pos = np.array([4000 * np.cos(th), 4000 * np.sin(th), 1100.0])
    z = np.array([0, 0, 900.0]) - pos
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0.0, 0.0, -1.0]), z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    f = rng.uniform(0.9, 1.3) * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
    return R.T, -R @ pos, K, width, height


def test_geometry_names_match():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.01, 0.99, (19, 1)).astype(np.float32)
    _close(tg.inverse_sigmoid(torch.tensor(x)), jg.inverse_sigmoid(x))
    sym = rng.normal(0, 1, (5, 3, 3)).astype(np.float32)
    sym = sym + np.swapaxes(sym, -1, -2)
    for name in ("strip_symmetric", "strip_lowerdiag"):
        got = getattr(tg, name)(torch.tensor(sym))
        assert np.array_equal(got.numpy(), np.asarray(getattr(jg, name)(sym)))
    s = np.exp(rng.normal(1, 0.5, (19, 3))).astype(np.float32)
    q = rng.normal(0, 1, (19, 4)).astype(np.float32)
    _close(tg.build_scaling_rotation(torch.tensor(s), torch.tensor(q)),
           jg.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q)))
    pts = rng.normal(0, 500, (2, 19, 3)).astype(np.float32)
    mat = rng.normal(0, 1, (4, 4)).astype(np.float32)
    mat[:, 3] = [0.1, -0.2, 0.3, 5.0]   # w away from 0
    _close(tg.geom_transform_points(torch.tensor(pts), torch.tensor(mat)),
           jg.geom_transform_points(jnp.asarray(pts), jnp.asarray(mat)))


def test_one_hot_features_and_model_init_match():
    for n in (15, 17, 19):
        got = tgaussians.one_hot_features(n, device="cpu")
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(),
                              np.asarray(jgaussians.one_hot_features(n)))
    pose = np.random.default_rng(1).normal(0, 300, (17, 3)).astype(np.float32)
    for scaling, modifier in ((3.0, 1.25), (0.0, 1.0)):
        jm = jgaussians.SkeletonModel("h36m", 17, scaling, modifier)
        tm = tgaussians.SkeletonModel("h36m", 17, scaling, modifier)
        jp, tp = jm.init(pose), tm.init(pose, device="cpu")
        for f in tgaussians.PARAM_FIELDS:
            assert np.array_equal(getattr(tp, f).numpy(),
                                  np.asarray(getattr(jp, f))), f


def test_cameras_extent_and_to_camera_match():
    rng = np.random.default_rng(2)
    infos = [(jcio.CameraInfo(v, *args), tcio.CameraInfo(v, *args))
             for v, args in enumerate(_camera(rng, w) for w in
                                      (1002, 1000, 1002, 1000))]
    jc = [j.to_camera() for j, _ in infos]
    tc = [t.to_camera(device="cpu") for _, t in infos]
    assert infos[0][1].to_camera(uid=7, device="cpu").uid.item() == \
        int(infos[0][0].to_camera(uid=7).uid)
    for a, b in zip(jc, tc):
        for f in tcameras.FIELDS:
            assert np.array_equal(getattr(b, f).numpy(),
                                  np.asarray(getattr(a, f))), f
    j_ext = jtrainer.cameras_extent(jcameras.stack_cameras(jc))
    t_ext = ttrainer.cameras_extent(tcameras.stack_cameras(tc))
    assert isinstance(t_ext, float) and t_ext == j_ext


def test_group_lrs_match():
    cfg = dict(iterations=500, position_lr_init=1.6e-4,
               position_lr_final=1.6e-6, position_lr_delay_mult=0.01,
               position_lr_max_steps=30000, scaling_lr=5e-3,
               rotation_lr=1e-3, opacity_lr=2.5e-2)
    jadam = joptim.AdamGroups(joptim.OptConfig(**cfg))
    tadam = toptim.AdamGroups(toptim.OptConfig(**cfg))
    for it in (1, 4, 250, 500):
        for extent in (1.0, 4619.8):
            jl = jadam.group_lrs(jnp.asarray(it), extent)
            tl = tadam.group_lrs(torch.tensor(float(it)), extent)
            assert type(tl).__name__ == "GaussianParams"
            for f in tgaussians.PARAM_FIELDS:
                _close(torch.as_tensor(getattr(tl, f)), getattr(jl, f))


@pytest.mark.parametrize("loss", ["l2_gaussian", "l1_gaussian", "l1_masked",
                                  "l1", "l1_masked_huber", "cauchy"])
@pytest.mark.parametrize("consistency", ["3D_length_consistency", "none"])
def test_fused_view_loss_available_matches(loss, consistency):
    assert tfused.fused_view_loss_available(loss, consistency) is \
        jfused.fused_view_loss_available(loss, consistency)


# JAX file → the port's file of the same job under another name
RENAMED_FILES = {"native/__init__.py": "native.py",
                 "ops/pallas_raster.py": "ops/cuda_raster.py"}
# (JAX file, name) → the port's name for the same job in the mapped file
RENAMED = {
    ("engine/trainer.py", "init_params_jnp"):
        ("core/gaussians.py", "init_params"),
    # an nn.Module: torch's __call__ runs forward
    ("ops/lpips.py", "LPIPS.__call__"): ("ops/lpips.py", "LPIPS.forward"),
    ("ops/pallas_raster.py", "fused_view_loss_pallas"):
        ("ops/cuda_raster.py", "fused_view_loss_cuda"),
    ("ops/pallas_raster.py", "make_pallas_view_loss"):
        ("ops/cuda_raster.py", "make_cuda_view_loss"),
    ("ops/pallas_raster.py", "pallas_view_profiles"):
        ("ops/cuda_raster.py", "view_profiles"),
}
# TPU- or XLA-only names, each with the reason the port has none
DECLINED = {
    ("__init__.py", "ensure_compile_cache"):
        "XLA's persistent compilation cache; nvcc's builds are cached "
        "under build/",
    ("ops/lpips.py", "LPIPS.export_torch_weights"):
        "needs torchvision and the network",
    ("ops/pallas_raster.py", "bwd_vmem_bytes"): "the TPU's VMEM budget",
    ("ops/pallas_raster.py", "pallas_view_bbox"): "the window tiers",
    ("ops/pallas_raster.py", "pallas_window_bounds"): "the window tiers",
    ("ops/pallas_raster.py", "window_bounds_from_bbox"): "the window tiers",
    ("ops/pallas_raster.py", "window_bounds_multi"): "the window tiers",
    ("tools/kernel_probe.py", "probe_tier"): "the window tiers",
    ("tools/roofline.py", "headline_tier"): "the window tiers",
    ("tools/roofline.py", "measure_activity"):
        "the TPU kernel's tile activity; K1's live-tile list replaces it",
    ("tools/trace_summary.py", "hlo_source_map"): "XLA's HLO",
    ("utils.py", "fetch_trees"): "engine/driver.py's _Fetch does its job",
}


def _names(path, with_imports: bool) -> set:
    """Top-level functions and classes of a file, its classes' public and
    dunder methods, and (``with_imports``) the names it assigns or
    imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, ast.FunctionDef))
        elif with_imports and isinstance(node, ast.ImportFrom):
            out.update(a.asname or a.name for a in node.names)
        elif with_imports and isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _public(name: str) -> bool:
    """A public function or class, or a public or dunder method of a
    public class."""
    *cls, last = name.split(".")
    return (not any(c.startswith("_") for c in cls)
            and (not last.startswith("_")
                 or (last.startswith("__") and last.endswith("__"))))


def test_every_public_name_has_a_counterpart():
    """Every public function, class and method of the JAX package, by
    file, is in the port's file of the same path (or its renamed file),
    or is renamed or declined above; the root entry's ``entry`` and
    ``_synthetic_inputs`` are in ``graft_entry.py``."""
    jroot = os.path.join(REPO, "skelsplat_tpu")
    troot = os.path.join(REPO, "skelsplat_tpu_torch")
    missing = set()
    for d, _, files in os.walk(jroot):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, fname), jroot)
            tpath = os.path.join(troot, RENAMED_FILES.get(rel, rel))
            have = (_names(tpath, True) if os.path.exists(tpath) else set())
            missing |= {(rel, n) for n in _names(os.path.join(d, fname),
                                                 False)
                        if _public(n) and n not in have}
    assert missing == set(RENAMED) | set(DECLINED), \
        sorted(missing ^ (set(RENAMED) | set(DECLINED)))
    for rel, name in RENAMED.values():
        assert name in _names(os.path.join(troot, rel), False), (rel, name)
    graft = _names(os.path.join(troot, "graft_entry.py"), False)
    root = _names(os.path.join(REPO, "__graft_entry__.py"), False)
    assert {"entry", "_synthetic_inputs"} <= root & graft
    assert "dryrun_multichip" in _names(
        os.path.join(troot, "parallel", "dryrun.py"), False)
