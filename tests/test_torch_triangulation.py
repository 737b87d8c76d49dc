"""The port's triangulation and render entry points against the JAX
package's: ``skelsplat_tpu_torch.triangulation`` (``--device cpu``)
against the root ``triangulation.py`` on the three datasets' synthetic
trees, ``triangulate_poses`` against ``skelsplat_tpu/triangulate.py`` on
rigs down to a near-degenerate baseline, and
``skelsplat_tpu_torch.render`` against the root ``render.py``'s PNGs.
Bars: triangulated points within 1e-9 relative (float64 SVDs on both
sides), PNG pixels within 1 level."""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from skelsplat_tpu import triangulate as jtri
from skelsplat_tpu_torch import render as trender_cli
from skelsplat_tpu_torch import train as ttrain_cli
from skelsplat_tpu_torch import triangulate as ttri
from skelsplat_tpu_torch import triangulation as ttri_cli
from skelsplat_tpu_torch.data import ply
from skelsplat_tpu_torch.tools import make_synthetic_dataset as synth

IMG = 96
REL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run the port's many small CPU ops on one torch thread: under the
    test run's parallel workers, an intra-op thread per core in every
    worker contends for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (tree layout, dataset overrides of triangulation.yaml)
LAYOUTS = {
    "h36m": ["dataset.initial_guess=metrabs", "dataset.poses_2d=metrabs",
             "dataset.frame_step=64"],
    "panoptic": [],
    "occlusion-person": ["dataset.initial_guess=triang_resnet",
                         "dataset.poses_2d=resnet"],
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    roots = {k: str(base / f"synth-{k}") for k in LAYOUTS}
    synth.write_tree(roots["h36m"], ["S9", "S11"], 128, 64, image_size=IMG)
    synth.write_panoptic_tree(roots["panoptic"], frames=3, image_size=IMG)
    synth.write_occlusion_person_tree(roots["occlusion-person"], frames=3,
                                      image_size=IMG)
    return roots


def _call(main, args):
    stdout = sys.stdout
    try:
        return main(args)
    finally:
        sys.stdout = stdout


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_triangulation_cli_matches_jax(trees, tmp_path, layout):
    import triangulation as jtri_cli

    args = ["--config-name", "triangulation.yaml",
            f"dataset.data_root={trees[layout]}", *LAYOUTS[layout]]
    runs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    _call(jtri_cli.main, [*args, f"hydra.run.dir={runs['jax']}"])
    _call(ttri_cli.main, ["--device", "cpu", *args,
                          f"hydra.run.dir={runs['port']}"])
    d = os.path.join("point_cloud", "iteration_0")
    names = sorted(os.listdir(runs["jax"] / d))
    assert sorted(os.listdir(runs["port"] / d)) == names
    assert len(names) >= 3
    for name in names:
        t, j = (ply.read_ply(str(runs[k] / d / name)) for k in ("port", "jax"))
        assert list(t) == list(j) == ["x", "y", "z"]
        xyz_t = np.stack([t[c] for c in "xyz"], 1)
        xyz_j = np.stack([j[c] for c in "xyz"], 1)
        assert xyz_t.dtype == np.float64
        assert np.abs(xyz_t - xyz_j).max() <= REL * np.abs(xyz_j).max(), name


def _rig(baseline, n_views):
    """Projections of ``n_views`` cameras 4 m from the origin, looking
    along +z, spaced ``baseline`` mm apart along x."""
    K = np.array([[1100.0, 0, 500], [0, 1100, 500], [0, 0, 1]])
    return [K @ np.hstack([np.eye(3), [[-baseline * v], [0], [4000.0]]])
            for v in range(n_views)]


@pytest.mark.parametrize("baseline, n_views", [(1500.0, 4), (1.0, 2),
                                               (1e-2, 2)])
def test_triangulate_poses_matches_jax(baseline, n_views):
    """Noisy detections of 17 joints; the 1e-2 mm baseline is a near-
    degenerate rig (depth barely constrained), where the null vector is
    still one direction that both SVDs find up to its sign."""
    rng = np.random.default_rng(0)
    X = np.c_[rng.normal(0, 300, (17, 3)), np.ones(17)]
    P = _rig(baseline, n_views)
    x = np.stack([X @ p.T for p in P])
    x = x[..., :2] / x[..., 2:] + rng.normal(0, 0.5, (n_views, 17, 2))
    ref = jtri.triangulate_poses(P, x)
    got = ttri.triangulate_poses(P, x, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (17, 4)
    got = got.numpy()
    assert (got[:, 3] == 1).all()
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()
    one = ttri.triangulate_points_multi_camera(P, x[:, 5], device="cpu")
    ref_one = jtri.triangulate_points_multi_camera(P, x[:, 5])
    assert np.abs(one.numpy() - ref_one).max() <= REL * np.abs(ref_one).max()
    if baseline > 1:   # a real rig recovers the points
        assert np.abs(got[:, :3] - X[:, :3]).max() < 20.0


def test_render_cli_matches_jax(trees, tmp_path):
    """The port's run of 4 iterations over 2 scenes, rendered by both
    entry points (each scene's 4 views in one batched call in the
    port)."""
    import render as jrender_cli

    root = trees["h36m"]
    run = tmp_path / "run"
    common = ["--config-name", "h36m.yaml", f"dataset.data_root={root}",
              "dataset.end_scene_id=2"]
    _call(ttrain_cli.main, ["--device", "cpu", *common,
                            "optimization.iterations=4",
                            "debug.save_iterations=[4]",
                            "debug.save_images=false",
                            f"hydra.run.dir={run}"])
    args = [*common, f"eval.output_path={run}", "render.iteration=4"]
    _call(jrender_cli.main, args)
    jax_pngs = {p.name: np.asarray(Image.open(p), dtype=np.int16)
                for p in (run / "renders").iterdir()}
    out = _call(trender_cli.main, ["--device", "cpu", *args])
    assert out == str(run / "renders")
    names = sorted(os.listdir(out))
    assert names == sorted(jax_pngs) and len(names) == 8
    for name in names:
        t = np.asarray(Image.open(run / "renders" / name), dtype=np.int16)
        assert t.shape == jax_pngs[name].shape == (IMG, IMG)
        assert np.abs(t - jax_pngs[name]).max() <= 1, name
        assert t.max() == 255
