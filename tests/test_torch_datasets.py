"""The round's end check on every dataset: the port's CLI
(``skelsplat_tpu_torch.train``/``.eval``, ``--device cpu``) against the JAX
CLI (the root ``train.py``/``eval.py``) on tiny synthetic trees of each
config: ``panoptic.yaml`` (19 joints), ``occlusion-person.yaml`` (15
joints, ``scaling_modifier`` 1.25), ``h36m-occ.yaml`` (``scaling_modifier``
1.25) and ``h36m.yaml`` with ``training.dropout=true``. Both write the
same PLYs, xyz within the Adam bar below, and score the same MPJPE within
1e-3 mm. Then ``pipeline.debug=true``: the same PLYs as without it, and a NaN in
an initial guess raises ``FloatingPointError``."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from skelsplat_tpu import evaluation as jeval
from skelsplat_tpu_torch import eval as teval_cli
from skelsplat_tpu_torch import train as ttrain_cli
from skelsplat_tpu_torch.data import ply
from skelsplat_tpu_torch.tools import make_synthetic_dataset as synth

ITERS = 24
SCENES = 2
IMG = 96
MM = 1e-3   # the bar on MPJPE and on each scene's logged error, mm
# xyz bar, mm. Where a joint's gradient nearly cancels over the views,
# Adam's normalized step turns the packages' ~1e-6 relative rounding
# difference into a step difference proportional to the learning rate:
# 1e-3 mm covers it at H36M's position_lr_init of 5e-4 (up to 6.6e-4 mm
# over ten seeds of the batch tests' rigs, test_torch_batch.XYZ_ATOL).
# Panoptic and Occlusion-Person step xyz at 10x that rate (5e-3), so
# their bar is 1e-2 mm: here Panoptic's scene 0,
# joint 15, parts by 1.5e-5, 3.3e-4, 1.0e-3, 4.5e-3 and 8.5e-3 mm after
# 4, 8, 12, 16 and 24 iterations while the losses agree within 7e-6
# relative, and the port's own kernel and dense renderers already part
# by 7.3e-4 mm there. A wrong GT, extent or fusion moves xyz by ~0.1 mm a
# step.
XYZ_MM = {"h36m": 1e-3, "h36m-occ": 1e-3, "panoptic": 1e-2,
          "occlusion-person": 1e-2}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run the port's many small CPU ops on one torch thread: under the
    test run's parallel workers, an intra-op thread per core in every
    worker contends for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tiny tree per dataset layout; the loader picks the layout from
    the root's name."""
    base = tmp_path_factory.mktemp("data")
    roots = {"panoptic": str(base / "synth-panoptic"),
             "occlusion-person": str(base / "synth-occlusion-person"),
             "h36m-occ": str(base / "synth-h36m-occ"),
             "h36m": str(base / "synth-h36m")}
    synth.write_panoptic_tree(roots["panoptic"], activities=("171204_pose5",),
                              frames=SCENES, image_size=IMG)
    synth.write_occlusion_person_tree(roots["occlusion-person"],
                                      frames=SCENES, image_size=IMG)
    synth.write_tree(roots["h36m-occ"], ["S9"], 128, 64, image_size=IMG,
                     detector="metrabs_occ_3")
    synth.write_tree(roots["h36m"], ["S9"], 128, 64, image_size=IMG)
    return roots


def _call(main, args):
    """Run a CLI main in-process; train's safe_state replaces stdout."""
    stdout = sys.stdout
    try:
        return main(args)
    finally:
        sys.stdout = stdout


def _args(config, root, run_dir, extra=()):
    return ["--config-name", f"{config}.yaml", f"dataset.data_root={root}",
            f"dataset.end_scene_id={SCENES}",
            f"optimization.iterations={ITERS}",
            f"debug.save_iterations=[{ITERS}]", "debug.save_images=false",
            f"hydra.run.dir={run_dir}", *extra]


def _plys(run_dir):
    d = os.path.join(run_dir, "point_cloud", f"iteration_{ITERS}")
    return {n: ply.read_xyz(os.path.join(d, n)) for n in sorted(os.listdir(d))}


CASES = {
    "panoptic": ("panoptic", "panoptic", ()),
    "occlusion-person": ("occlusion-person", "occlusion-person", ()),
    "h36m-occ": ("h36m-occ", "h36m-occ", ()),
    "h36m-dropout": ("h36m", "h36m", ("training.dropout=true",)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_cli_matches_jax_cli(trees, tmp_path, case):
    import train as jtrain_cli

    config, layout, extra = CASES[case]
    root = trees[layout]
    jrun, trun = str(tmp_path / "jax"), str(tmp_path / "port")
    _call(jtrain_cli.main, _args(config, root, jrun, extra))
    _call(ttrain_cli.main, ["--device", "cpu",
                            *_args(config, root, trun, extra)])

    jp, tp = _plys(jrun), _plys(trun)
    assert list(tp) == list(jp) and len(tp) == SCENES
    n_joints = {"panoptic": 19, "occlusion-person": 15}.get(layout, 17)
    for name in jp:
        assert tp[name].shape == (n_joints, 3)
        assert np.abs(tp[name] - jp[name]).max() <= XYZ_MM[config], name
    js, ts = (json.load(open(os.path.join(r, "train_summary.json")))["scenes"]
              for r in (jrun, trun))
    for t, j in zip(ts, js):
        assert t["scene_name"] == j["scene_name"]
        assert abs(t["abs_error"] - j["abs_error"]) <= MM

    gt = os.path.join(root, "3d_gt")
    ref = jeval.evaluate(gt, jrun, [ITERS], 0, SCENES, print_fn=lambda s: 0)
    got = _call(teval_cli.main, ["--device", "cpu", *_args(config, root, trun),
                                 f"eval.output_path={trun}"])
    for k in ("absolute", "relative"):
        assert np.isfinite(got[ITERS][k])
        assert abs(got[ITERS][k] - ref[ITERS][k]) <= MM, k
    if case == "h36m-dropout":
        # the masks moved the result: a run without dropout differs
        _call(ttrain_cli.main, ["--device", "cpu",
                                *_args(config, root, str(tmp_path / "plain"))])
        plain = _plys(str(tmp_path / "plain"))
        assert max(np.abs(plain[n] - tp[n]).max() for n in tp) > 1e-3


def test_debug_mode_changes_nothing_and_raises_on_nan(trees, tmp_path):
    root = trees["h36m"]
    runs = {}
    for debug in ("false", "true"):
        run = str(tmp_path / f"debug_{debug}")
        _call(ttrain_cli.main, ["--device", "cpu", *_args(
            "h36m", root, run, (f"pipeline.debug={debug}",))])
        runs[debug] = _plys(run)
    for name, xyz in runs["false"].items():
        np.testing.assert_array_equal(runs["true"][name], xyz)

    bad = tmp_path / "synth-h36m"
    shutil.copytree(root, bad)
    for path in bad.glob("initial_guess/**/poses.npz"):
        poses = np.load(path)["poses"]
        poses[..., 3, 0] = np.nan
        np.savez(path, poses=poses)
    with pytest.raises(FloatingPointError, match="macro step 0 "):
        _call(ttrain_cli.main, ["--device", "cpu", *_args(
            "h36m", str(bad), str(tmp_path / "nan"), ("pipeline.debug=true",))])


@pytest.mark.parametrize("layout, size, default", [
    ("panoptic", (160, 90), (1920, 1080)),
    ("occlusion-person", (128, 72), (1280, 720))])
def test_trees_at_a_width_and_height(tmp_path, layout, size, default):
    """The synthetic tool writes a (width, height) rig; the cameras' real
    size is the loader's default and is left out of the calibration."""
    from skelsplat_tpu_torch.data import cameras_io
    from skelsplat_tpu_torch.data.loader import DataLoader

    writer = (synth.write_panoptic_tree if layout == "panoptic"
              else synth.write_occlusion_person_tree)
    detector = "metrabs" if layout == "panoptic" else "resnet"
    for sz in (size, default):
        root = tmp_path / f"{sz[0]}x{sz[1]}" / f"synth-{layout}"
        writer(str(root), frames=1, image_size=sz)
        loader = DataLoader(str(root),
                            str(root / "initial_guess" / f"triang_{detector}"),
                            str(root / f"2d_{detector}"), frame_step=1,
                            nviews=4)
        _, rec = next(iter(loader))
        cams = cameras_io.build_camera_batch(rec.cameras, device="cpu")
        assert cams.width.tolist() == [sz[0]] * 4
        assert cams.height.tolist() == [sz[1]] * 4
        calib = (root / "3d_gt" / "cameras" / "calibration_171204_pose5.json"
                 if layout == "panoptic" else root / "cameras.json")
        assert ('"image_size"' in calib.read_text()) == (sz != default)
        # every detection lies inside the image
        p2d = np.asarray(rec.poses_2d)[..., :2]
        assert (p2d > 0).all() and (p2d[..., 0] < sz[0]).all() \
            and (p2d[..., 1] < sz[1]).all()
