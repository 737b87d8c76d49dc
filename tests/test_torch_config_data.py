"""The port's config, PLY, camera, loader, synthetic-tree, dropout and eval
layers against the JAX package's, on the same files and seeded arrays
(numpy and JSON only: no trainer is compiled)."""

import dataclasses
import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import skelsplat_tpu.config as jconfig
import skelsplat_tpu_torch.config as tconfig
from skelsplat_tpu import evaluation as jeval
from skelsplat_tpu.core import gaussians as jgaussians
from skelsplat_tpu.data import cameras_io as jcio
from skelsplat_tpu.data import ply as jply
from skelsplat_tpu.data.loader import DataLoader as JLoader
from skelsplat_tpu.ops import heatmaps as jheatmaps
from skelsplat_tpu.tools import make_synthetic_dataset as jsynth
from skelsplat_tpu_torch import evaluation as teval
from skelsplat_tpu_torch.core import gaussians as tgaussians
from skelsplat_tpu_torch.core.cameras import FIELDS as CAMERA_FIELDS
from skelsplat_tpu_torch.data import cameras_io as tcio
from skelsplat_tpu_torch.data import ply as tply
from skelsplat_tpu_torch.data.loader import DataLoader as TLoader
from skelsplat_tpu_torch.ops import heatmaps as theatmaps
from skelsplat_tpu_torch.tools import make_synthetic_dataset as tsynth
from skelsplat_tpu_torch.utils import safe_state

CONFIGS = ["h36m.yaml", "h36m-occ.yaml", "panoptic.yaml",
           "occlusion-person.yaml", "triangulation.yaml"]
# the override forms the JAX suite and the docs use, and YAML typing cases
OVERRIDES = ["dataset.data_root=/data/synth-h36m", "dataset.end_scene_id=4",
             "optimization.iterations=24", "debug.save_iterations=[12, 24]",
             "debug.save_images=false", "+training.skip_existing=true",
             "training.early_stopping=opt_early_stopping",
             "training.lambda_consistency=1.0e-05", "training.scene_batch=8",
             "model.scaling_modifier=1.25", "training.std_dev_noise=5",
             "render.iteration=200", "eval.output_path=experiments/x/y"]

# dataset layouts: (dir name, initial guess dir, 2D detector, nviews)
LAYOUTS = {
    "h36m": ("synth-h36m", "metrabs", "metrabs", 4),
    # image_size 1000: no sizes in the calibration, so the H36M size table
    # gives each camera's (mixed 1002/1000 x 1000) size
    "h36m-table": ("synth-h36m-table", "metrabs", "metrabs", 4),
    "panoptic": ("synth-panoptic", "triang_metrabs", "metrabs", 4),
    "occlusion-person": ("synth-occlusion-person", "triang_resnet", "resnet",
                         4),
}


def _write(mod, layout, root):
    if layout.startswith("h36m"):
        return mod.write_tree(root, ["S9", "S11"], 128, 64,
                              image_size=96 if layout == "h36m" else 1000)
    if layout == "panoptic":
        return mod.write_panoptic_tree(root, frames=3, image_size=96)
    return mod.write_occlusion_person_tree(root, frames=3, image_size=96)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Each layout written by the JAX tool and by the port's."""
    out = {}
    for layout, (name, *_) in LAYOUTS.items():
        base = tmp_path_factory.mktemp(layout)
        jroot, troot = str(base / "jax" / name), str(base / "port" / name)
        assert _write(jsynth, layout, jroot) == _write(tsynth, layout, troot)
        out[layout] = (jroot, troot)
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_config_copies_and_load_config(name, tmp_path):
    jpath = os.path.join(jconfig.DEFAULT_CONFIG_DIR, name)
    tpath = os.path.join(tconfig.DEFAULT_CONFIG_DIR, name)
    assert filecmp.cmp(jpath, tpath, shallow=False)
    for make_run_dir in (False, True):
        ovr = OVERRIDES + ([f"hydra.run.dir={tmp_path}/{{}}"]
                           if make_run_dir else [])
        j = jconfig.load_config(name, [o.format("jax") for o in ovr],
                                make_run_dir=make_run_dir)
        t = tconfig.load_config(name, [o.format("port") for o in ovr],
                                make_run_dir=make_run_dir)
        jd, td = j.to_dict(), t.to_dict()
        if make_run_dir:
            assert j.run_dir == f"{tmp_path}/jax" and t.run_dir == f"{tmp_path}/port"
            assert filecmp.cmp(f"{j.run_dir}/.hydra/config.yaml",
                               f"{t.run_dir}/.hydra/config.yaml", shallow=False)
            jd["hydra"] = td["hydra"] = None
        else:
            # the ${now:...} template resolves to the same shape
            assert j.run_dir.count("/") == t.run_dir.count("/")
        assert jd == td
        for group in ("dataset", "training", "debug", "model",
                      "optimization", "pipeline"):
            if group in jd:
                assert j[group].to_dict() == t[group].to_dict()
    assert tconfig.parse_overrides(OVERRIDES) == \
        jconfig.parse_overrides(OVERRIDES)
    with pytest.raises(SystemExit):
        tconfig.parse_overrides(["dataset.end_scene_id"])


def test_latest_run_dir_matches(tmp_path):
    for run in ("2026-01-02/10-00-00", "2026-01-02/11-00-00",
                "2026-01-03/09-00-00"):
        (tmp_path / run).mkdir(parents=True)
        (tmp_path / run / "x").write_text("")
    (tmp_path / "2026-01-04" / "00-00-00").mkdir(parents=True)   # empty
    tmpl = str(tmp_path) + "/${now:%Y-%m-%d}/${now:%H-%M-%S}"
    j = jconfig.load_config("h36m.yaml", [f"hydra.run.dir={tmpl}"],
                            make_run_dir=False)
    t = tconfig.load_config("h36m.yaml", [f"hydra.run.dir={tmpl}"],
                            make_run_dir=False)
    assert tconfig.latest_run_dir(t) == jconfig.latest_run_dir(j) == \
        str(tmp_path / "2026-01-03" / "09-00-00")


@pytest.mark.parametrize("name,trainer",
                         [("h36m.yaml", True), ("triangulation.yaml", False)])
def test_config_methods_match(name, trainer):
    """``in``, ``get``, ``extract`` and the handlers' ``extract`` give the
    JAX package's results, with the same types."""
    j = jconfig.load_config(name, OVERRIDES, make_run_dir=False)
    t = tconfig.load_config(name, OVERRIDES, make_run_dir=False)
    for key in ("training", "dataset", "debug", "hydra", "defaults", "eval",
                "render", "nope", 0):
        assert (key in t) is (key in j), key
    for key, default in (("training", None), ("nope", None), ("nope", 7),
                         ("hydra", "x"), ("dataset", 3)):
        jv, tv = j.get(key, default), t.get(key, default)
        assert type(tv).__name__ == type(jv).__name__, key
        if isinstance(jv, jconfig.ParamGroup):
            assert tv.extract() is tv and tv.to_dict() == jv.to_dict()
        else:
            assert tv == jv
    handlers = [(jconfig.TriangulationConfigHandler,
                 tconfig.TriangulationConfigHandler)]
    if trainer:
        handlers.append((jconfig.ConfigHandler, tconfig.ConfigHandler))
    for jh, th in handlers:
        je, te = jh(j).extract(), th(t).extract()
        assert list(te) == list(je)
        for group in je:
            assert isinstance(te[group], tconfig.ParamGroup)
            assert te[group] is getattr(t, group)
            assert te[group].to_dict() == je[group].to_dict()


def test_ply_writers_byte_identical_and_readers_roundtrip(tmp_path):
    rng = np.random.default_rng(11)
    n = 17
    xyz = rng.normal(0, 500, (n, 3))
    ls, q = rng.normal(0, 1, (n, 3)), rng.normal(0, 1, (n, 4))
    op = rng.normal(0, 1, (n, 1))
    rgb = rng.integers(0, 256, (n, 3))
    writers = [
        ("g.ply", lambda m, p: m.write_gaussian_ply(p, xyz, ls, q, op)),
        ("gf.ply", lambda m, p: m.write_gaussian_ply(
            p, xyz, ls, q, op, features_dc=rng_fdc)),
        ("p.ply", lambda m, p: m.write_point_ply(p, xyz, rgb)),
        ("d.ply", lambda m, p: m.write_xyz_double_ply(p, xyz)),
    ]
    rng_fdc = np.random.default_rng(2).normal(0, 1, (n, 1, 3))
    for name, write in writers:
        jp, tp = str(tmp_path / "jax" / name), str(tmp_path / "port" / name)
        write(jply, jp)
        write(tply, tp)
        assert filecmp.cmp(jp, tp, shallow=False), name
        np.testing.assert_equal(tply.read_ply(tp), jply.read_ply(jp))
        np.testing.assert_array_equal(tply.read_xyz(tp), jply.read_xyz(jp))
        np.testing.assert_allclose(tply.read_xyz(tp), xyz, rtol=1e-6)
    got = tply.read_gaussian_ply(str(tmp_path / "port" / "g.ply"))
    ref = jply.read_gaussian_ply(str(tmp_path / "jax" / "g.ply"))
    np.testing.assert_equal(got, ref)
    np.testing.assert_array_equal(got["features_dc"], np.eye(n))
    np.testing.assert_array_equal(got["quats"], q.astype(np.float32))
    # an ascii PLY
    path = tmp_path / "a.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 2\nproperty float "
                    "x\nproperty float y\nproperty float z\nend_header\n"
                    "1 2 3\n4 5 6\n")
    np.testing.assert_array_equal(tply.read_xyz(str(path)),
                                  jply.read_xyz(str(path)))


def test_synthetic_trees_match_the_jax_tool(trees):
    for layout, (jroot, troot) in trees.items():
        files = []
        for d, _, fs in os.walk(jroot):
            files += [os.path.relpath(os.path.join(d, f), jroot) for f in fs]
        tfiles = [os.path.relpath(os.path.join(d, f), troot)
                  for d, _, fs in os.walk(troot) for f in fs]
        assert sorted(files) == sorted(tfiles) and files, layout
        for rel in files:
            a, b = os.path.join(jroot, rel), os.path.join(troot, rel)
            if rel.endswith(".npz"):
                za, zb = np.load(a), np.load(b)
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k])
            else:
                assert filecmp.cmp(a, b, shallow=False), rel


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_loader_records_and_cameras_match(trees, layout):
    root = trees[layout][1]
    _, guess, det, nviews = LAYOUTS[layout]
    args = (root, os.path.join(root, "initial_guess", guess),
            os.path.join(root, "2d_" + det))
    kw = dict(frame_step=64 if layout.startswith("h36m") else 1, start_id=1,
              end_id=5, nviews=nviews)
    jl, tl = JLoader(*args, **kw), TLoader(*args, **kw)
    assert len(tl) == len(jl) > 1
    assert (tl.n_joints, tl.im_width, tl.im_height) == \
        (jl.n_joints, jl.im_width, jl.im_height)
    for (ji, jr), (ti, tr) in zip(jl, tl):
        assert ti == ji and tr.scene_id == jr.scene_id
        assert tr.scene_name == jr.scene_name
        for f in ("pose_3d", "pose_3d_gt", "poses_2d"):
            np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))
            assert getattr(tr, f).dtype == getattr(jr, f).dtype
        assert len(tr.cameras) == len(jr.cameras) == nviews
        if layout == "h36m-table":
            assert {c.width for c in tr.cameras} == {1000, 1002}
        for i, (jc, tc) in enumerate(zip(jr.cameras, tr.cameras)):
            for f in ("uid", "width", "height"):
                assert getattr(tc, f) == getattr(jc, f)
            for f in ("R", "T", "K"):
                np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
            assert tcio.camera_to_json(i, tc) == jcio.camera_to_json(i, jc)
        jb = jcio.build_camera_batch(jr.cameras)
        tb = tcio.build_camera_batch(tr.cameras, device="cpu")
        for f in CAMERA_FIELDS:
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)), f)
    assert tgaussians.scene_type_of(root) == jgaussians.scene_type_of(root)
    assert dataclasses.astuple(
        tgaussians.SkeletonModel.for_dataset(root, 2.0, 1.25)) == \
        dataclasses.astuple(jgaussians.SkeletonModel.for_dataset(root, 2.0,
                                                                 1.25))


def test_h36m_size_table_and_camera_names_match():
    assert tcio.H36M_CAMERA_SIZE == jcio.H36M_CAMERA_SIZE
    for f in ("H36M_CAMERAS", "PANOPTIC_CAMERAS", "OP_CAMERAS"):
        assert getattr(tcio, f) == getattr(jcio, f)
    with pytest.raises(ValueError):
        tgaussians.scene_type_of("data/unknown")


def test_dropout_draws_match_the_global_generator_sequence():
    """The port's per-scene draws from safe_state's generator equal the JAX
    function's draws from torch's global generator after
    torch.manual_seed(0), scene by scene (the JAX CLI's safe_state seeds
    the global generator); the global generator is left alone."""
    scenes = [(4, 17), (4, 17), (8, 19), (4, 15), (4, 17)]
    stdout = sys.stdout
    try:
        gen = safe_state(True)
    finally:
        sys.stdout = stdout
    before = torch.random.get_rng_state()
    got = [theatmaps.dropout_masks_torch(v, n, gen) for v, n in scenes]
    assert torch.equal(torch.random.get_rng_state(), before)
    torch.manual_seed(0)
    ref = [jheatmaps.dropout_masks_torch(v, n) for v, n in scenes]
    for g, r in zip(got, ref):
        assert g.dtype == np.bool_ and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert sum(int(g.sum()) for g in got) > 0


def test_evaluate_matches_on_one_ply_tree(trees, tmp_path, capsys):
    for layout in ("h36m", "panoptic"):
        root = trees[layout][1]
        _, guess, det, nviews = LAYOUTS[layout]
        loader = TLoader(root, os.path.join(root, "initial_guess", guess),
                         os.path.join(root, "2d_" + det),
                         frame_step=64 if layout == "h36m" else 1,
                         nviews=nviews)
        run = tmp_path / layout
        rng = np.random.default_rng(4)
        for it in (12, 24):
            for _, r in loader:
                xyz = r.pose_3d_gt + rng.normal(0, 20 / it, r.pose_3d_gt.shape)
                n = xyz.shape[0]
                tply.write_gaussian_ply(
                    str(run / "point_cloud" / f"iteration_{it}"
                        / f"{r.scene_name}.ply"),
                    xyz, np.zeros((n, 3)), np.tile([1.0, 0, 0, 0], (n, 1)),
                    np.full((n, 1), 40.0))
        gt = os.path.join(root, "3d_gt")
        for start, end in ((0, len(loader)), (1, 3)):
            got = teval.evaluate(gt, str(run), [12, 24], start, end,
                                 nviews=nviews)
            ref = jeval.evaluate(gt, str(run), [12, 24], start, end,
                                 nviews=nviews)
            np.testing.assert_equal(got, ref)
            assert got[24]["absolute"] < got[12]["absolute"]
    out = capsys.readouterr().out
    assert "Absolute MPJPE" in out and "Relative MPJPE" in out


def test_ported_yaml_dump_reads_back(tmp_path):
    """The run dir's .hydra/config.yaml holds the resolved config."""
    t = tconfig.load_config("panoptic.yaml", OVERRIDES
                            + [f"hydra.run.dir={tmp_path}/run"])
    with open(tmp_path / "run" / ".hydra" / "config.yaml") as f:
        dumped = yaml.safe_load(f)
    d = t.to_dict()
    d.pop("hydra")
    assert dumped == d
    assert json.loads(json.dumps(d["debug"]["save_iterations"])) == [12, 24]
