"""The port's dataset tools (``skelsplat_tpu_torch/tools/``) against the JAX
package's on the same numpy-seeded raw inputs: each pair of ``main(argv)``
calls writes two trees that must hold the same files, the same npz keys
and the same JSON. Arrays from the file conversions are bitwise equal;
the monocular-3D fusion (torch float64 on the CPU here) agrees within
FUSE_ATOL_MM, NaNs included."""

import importlib
import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from skelsplat_tpu.tools import initial_guess as jig
from skelsplat_tpu_torch.data import colmap, ply
from skelsplat_tpu_torch.data.cameras_io import H36M_CAMERAS, PANOPTIC_CAMERAS
from skelsplat_tpu_torch.data.loader import DataLoader
from skelsplat_tpu_torch.tools import initial_guess as tig
from skelsplat_tpu_torch.tools import make_synthetic_dataset

# fused poses are thousands of mm: float64 leaves ~1e-12 mm between the
# packages' contractions
FUSE_ATOL_MM = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops on one torch thread (the tier-1 run's
    parallel workers would contend for the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tools(name):
    return (importlib.import_module(f"skelsplat_tpu.tools.{name}"),
            importlib.import_module(f"skelsplat_tpu_torch.tools.{name}"))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_array(a, b, atol):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    if a.dtype == object:    # frames that may be None
        for x, y in zip(a.ravel(), b.ravel()):
            assert (x is None and y is None) or (
                np.asarray(x).dtype == np.asarray(y).dtype
                and np.asarray(x).tobytes() == np.asarray(y).tobytes())
    elif atol is None:
        assert a.tobytes() == b.tobytes()
    else:
        assert np.array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        assert np.abs(a[ok] - b[ok]).max(initial=0.0) <= atol


def assert_same_tree(a, b, atol_under=None, atol=FUSE_ATOL_MM):
    """Trees ``a`` and ``b`` hold the same files: npz with the same keys and
    bitwise arrays (within ``atol`` under the ``atol_under`` subpath), PNG
    equal as decoded pixels, anything else (JSON too) byte-equal.
    Returns the number of files."""
    from PIL import Image

    names = _files(a)
    assert names and names == _files(b), (names, _files(b))
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            tol = (atol if atol_under and name.startswith(atol_under)
                   else None)
            with np.load(pa, allow_pickle=True) as za, \
                    np.load(pb, allow_pickle=True) as zb:
                assert za.files == zb.files, name
                for k in za.files:
                    _same_array(za[k], zb[k], tol)
        elif name.endswith(".png"):
            assert np.array_equal(np.asarray(Image.open(pa)),
                                  np.asarray(Image.open(pb))), name
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name
    return len(names)


def _run_both(name, tmp_path, argv, src=None, port_args=()):
    """Both packages' ``name`` tool: on a copy each of ``src`` when given
    (tools that write into their input tree), with ``argv(root)``, and
    ``port_args`` for the port's. Returns the two roots."""
    roots = []
    for tag, mod in zip(("jax", "torch"), _tools(name)):
        root = tmp_path / tag
        if src is not None:
            shutil.copytree(src, root)
        mod.main([*argv(str(root)), *(port_args if tag == "torch" else ())])
        roots.append(str(root))
    return roots


# ------------------------------- the fusion --------------------------------

def _fusion_inputs(rng, zero_error=False):
    """(C,F,J,3) poses, (C,F,J,2) detections, C (3,4) projections. With
    ``zero_error``, integer affine cameras and camera 0's pose projected
    exactly at frame 1, joint 2 (every view sees it with error 0)."""
    C, F, J = 4, 3, 17
    if zero_error:
        P = np.zeros((C, 3, 4))
        for v in range(C):
            P[v, 0, 0] = P[v, 1, 1] = 2.0 + v
            P[v, :2, 3] = rng.integers(-50, 50, 2)
            P[v, 2, 3] = 1.0
        poses = rng.integers(-900, 900, (C, F, J, 3)).astype(np.float64)
        det = (np.einsum("vij,vfkj->vfki", P[:, :2, :3], poses)
               + P[:, None, None, :2, 3] + rng.normal(0, 3.0, (C, F, J, 2)))
        det[:, 1, 2] = (P[:, :2, :3] @ poses[0, 1, 2]) + P[:, :2, 3]
        return poses, det, list(P)
    gt = make_synthetic_dataset.make_motion(F, J, seed=int(rng.integers(99)))
    cams = make_synthetic_dataset.make_rig(n_views=C)
    P = [K @ np.hstack([R, t.reshape(3, 1)]) for K, R, t in cams]
    poses = gt[None] + rng.normal(0, 30.0, (C, F, J, 3)) \
        + rng.normal(0, 25.0, (C, 1, 1, 3))
    det = np.stack([np.stack([make_synthetic_dataset.project(K, R, t, f)
                              for f in gt]) for K, R, t in cams])
    return poses, det + rng.normal(0, 2.0, det.shape), P


@pytest.mark.parametrize("zero_error", [False, True])
@pytest.mark.parametrize("fn", ["reprojection_errors", "errors_to_weights",
                                "fuse_poses"])
def test_fusion_matches_jax(fn, zero_error):
    rng = np.random.default_rng(7)
    poses, det, P = _fusion_inputs(rng, zero_error)
    with np.errstate(divide="ignore", invalid="ignore"):
        errs = jig.reprojection_errors(poses, det, P)
        args = (errs, 1) if fn == "errors_to_weights" else (poses, det, P)
        want = getattr(jig, fn)(*args)
    got = getattr(tig, fn)(*args, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    _same_array(got, want, FUSE_ATOL_MM)
    if zero_error and fn != "reprojection_errors":
        # the zero error's infinite weight makes NaN, as in numpy
        nan = np.isnan(got)
        assert nan.any() and not np.isnan(np.delete(
            got, 1, axis=0)).any(), np.argwhere(nan)
    else:
        assert np.isfinite(got).all()


def test_fusion_never_falls_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    poses, det, P = _fusion_inputs(np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tig.fuse_poses(poses, det, P)
    _, port = _tools("h36m.compute_initial_guess")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port.main(["--root_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def _h36m_mono_tree(root, rng):
    """A synthetic H36M tree plus what the fusion reads: per-camera mono
    predictions (GT + noise + a per-camera offset), detections under
    2d_resnet and the camera JSON under 3d_gt/cameras. S11/Walking has no
    detections (the tool skips it), S9/Walking holds a camera directory
    without predictions and S9 a stray file."""
    make_synthetic_dataset.write_tree(str(root), ["S9", "S11"], 96, 32,
                                      image_size=96)
    shutil.copytree(root / "initial_guess" / "cameras",
                    root / "3d_gt" / "cameras")
    for subject in ("S9", "S11"):
        for act in make_synthetic_dataset.ACTIVITIES:
            gt = np.load(root / "3d_gt" / subject / act / "poses.npz")[
                "poses"][::32]
            for cam in H36M_CAMERAS:
                d3 = root / "3d_metrabs_mono" / subject / act / cam
                d3.mkdir(parents=True)
                np.savez(d3 / "poses.npz", poses3d=gt + rng.normal(
                    0, 15.0, gt.shape) + rng.normal(0, 30.0, 3))
                if (subject, act) == ("S11", "Walking"):
                    continue
                p2 = np.load(root / "2d_metrabs" / subject / act / cam
                             / "poses.npz")["poses"]
                d2 = root / "2d_resnet" / subject / act / cam
                d2.mkdir(parents=True)
                np.savez(d2 / "poses.npz", poses2d=np.concatenate(
                    [p2, np.ones(p2.shape[:-1] + (1,))], axis=-1))
    (root / "3d_metrabs_mono" / "S9" / "Walking" / "extra").mkdir()
    (root / "3d_metrabs_mono" / "S9" / "stray.txt").write_text("x")


def test_h36m_initial_guess_matches_jax(tmp_path):
    src = tmp_path / "src-h36m"
    _h36m_mono_tree(src, np.random.default_rng(1))
    a, b = _run_both("h36m.compute_initial_guess", tmp_path,
                     lambda r: ["--root_dir", r], src=src,
                     port_args=("--device", "cpu"))
    assert assert_same_tree(a, b, atol_under="initial_guess/metrabs_resnet")
    out = os.path.join(b, "initial_guess", "metrabs_resnet")
    assert sorted(_files(out)) == [
        os.path.join(s, a, "poses.npz") for s, a in (
            ("S11", "Directions"), ("S9", "Directions"), ("S9", "Walking"))]
    fused = np.load(os.path.join(out, "S9", "Walking", "poses.npz"))[
        "poses3d"]
    assert fused.shape == (3, 17, 3) and np.isfinite(fused).all()


# ----------------------------- H36M converters -----------------------------

def _h36m_raw(tmp_path, rng):
    raw = tmp_path / "raw"
    raw.mkdir()
    n = sum(_tools("h36m.preprocess_resnet_2d_poses")[1].ACTIVITIES_LENGTH)
    np.savez(raw / "resnet.npz", preds=rng.normal(0, 300, (4 * n, 17, 3)))
    np.savez(raw / "metrabs3d.npz",
             coords3d_pred_world=rng.normal(0, 900, (4 * n, 17, 3)))
    cpn = {s: {a: [rng.normal(0, 400, (7, 34)) for _ in range(4)]
               for a in ("Directions", "Walking 1")} for s in ("S9", "S11")}
    np.save(raw / "positions_2d.npy", np.array(cpn, dtype=object),
            allow_pickle=True)
    for s in ("S9", "S11"):
        for a in ("Eating", "Posing 1"):
            (raw / "metrabs2d" / s / a).mkdir(parents=True)
            np.savez(raw / "metrabs2d" / s / a / "poses2d.npz",
                     poses2d=rng.normal(0, 400, (4, 5, 17, 2)))
        bb = raw / "h36m" / s / "BBoxes"
        bb.mkdir(parents=True)
        for a, cam in (("Directions", H36M_CAMERAS[0]),
                       ("Walking 1", H36M_CAMERAS[3])):
            np.save(bb / f"{a}.{cam}.npy", rng.normal(0, 50, (6, 4)))
        np.save(bb / "malformed.npy", np.zeros(2))
    (raw / "h36m" / "notes.txt").write_text("not a subject")
    return raw


@pytest.mark.parametrize("tool", [
    "h36m.preprocess_h36m_gt", "h36m.preprocess_cpn_2d_poses",
    "h36m.preprocess_resnet_2d_poses", "h36m.preprocess_metrabs_predictions"])
def test_h36m_converters_match_jax(tmp_path, tool):
    raw = _h36m_raw(tmp_path, np.random.default_rng(2))
    argv = {
        "h36m.preprocess_h36m_gt": lambda r: [
            "--root_dir", str(raw / "h36m"), "--output_dir", r],
        "h36m.preprocess_cpn_2d_poses": lambda r: [
            "--input_file", str(raw / "positions_2d.npy"), "--output_dir", r,
            "--frame_step", "3"],
        "h36m.preprocess_resnet_2d_poses": lambda r: [
            "--input_file", str(raw / "resnet.npz"), "--output_dir", r],
        "h36m.preprocess_metrabs_predictions": lambda r: [
            "--input_dir", str(raw / "metrabs2d"), "--preds_3d",
            str(raw / "metrabs3d.npz"), "--output_dir", r],
    }[tool]
    a, b = _run_both(tool, tmp_path, argv)
    n = assert_same_tree(a, b)
    assert n >= 4, n


def test_h36m_gt_cdflib_gate_matches_jax(tmp_path, monkeypatch):
    """Without cdflib, a CDF file stops both tools with the same message."""
    monkeypatch.setitem(sys.modules, "cdflib", None)   # import → ImportError
    d3 = tmp_path / "raw" / "S9" / "MyPoseFeatures" / "D3_Positions"
    d3.mkdir(parents=True)
    (d3 / "Directions.cdf").write_bytes(b"\0" * 16)
    codes = []
    for tag, mod in zip(("jax", "torch"), _tools("h36m.preprocess_h36m_gt")):
        with pytest.raises(SystemExit) as exc:
            mod.main(["--root_dir", str(tmp_path / "raw"),
                      "--output_dir", str(tmp_path / tag)])
        assert isinstance(exc.value.__cause__, ImportError)
        codes.append(exc.value.code)
    assert codes[0] == codes[1] and "cdflib" in codes[0], codes


# ------------------------- Panoptic, end to end ----------------------------

PAN_SEQ = "171204_pose5"


def _panoptic_raw(tmp_path, rng, frames=6):
    """A Panoptic-toolbox sequence (hdPose3d COCO19 JSON in cm, the
    calibration JSON) and MeTRAbs per-camera predictions (world mm), one
    frame NaN in one view and one None in another."""
    tb = tmp_path / "toolbox" / PAN_SEQ
    (tb / "hdPose3d_stage1_coco19").mkdir(parents=True)
    cams = make_synthetic_dataset.make_rig(n_views=len(PANOPTIC_CAMERAS),
                                           img=(1920, 1080))
    calib = {"cameras": [   # the toolbox's t is in cm
        {"name": name, "type": "hd", "resolution": [1920, 1080],
         "K": K.tolist(), "R": R.tolist(), "t": (t / 10).reshape(3, 1).tolist(),
         "distCoef": rng.normal(0, 1e-3, 5).tolist()}
        for name, (K, R, t) in zip(PANOPTIC_CAMERAS, cams)]}
    (tb / f"calibration_{PAN_SEQ}.json").write_text(json.dumps(calib))
    gt = make_synthetic_dataset.make_motion(frames, 19, seed=3)     # mm
    for f in range(frames):
        body = {"id": 0, "joints19": np.concatenate(
            [gt[f] / 10, np.ones((19, 1))], axis=1).reshape(-1).tolist()}
        (tb / "hdPose3d_stage1_coco19" / f"body3DScene_{f:08d}.json"
         ).write_text(json.dumps({"bodies": [body]}))
    (tb / "hdPose3d_stage1_coco19" / "body3DScene_99999998.json").write_text(
        json.dumps({"bodies": []}))
    (tb / "hdPose3d_stage1_coco19" / "body3DScene_99999999.json").write_text(
        "{broken")
    preds = tmp_path / "metrabs"
    for v, (name, (K, R, t)) in enumerate(zip(PANOPTIC_CAMERAS[:3], cams)):
        d = preds / PAN_SEQ / name
        d.mkdir(parents=True)
        p3 = gt + rng.normal(0, 15.0, gt.shape) + rng.normal(0, 30, 3)
        p2 = np.stack([make_synthetic_dataset.project(K, R, t, g)
                       for g in gt]) + rng.normal(0, 2.0, (frames, 19, 2))
        if v == 0:
            p3[1, 4, 2] = np.nan
        if v == 1:
            frames_v = np.empty(frames, dtype=object)
            for i in range(frames):
                frames_v[i] = p3[i]
            frames_v[3] = None
            p3 = frames_v
        np.savez(d / "poses3d_world.npz", poses=p3)
        np.savez(d / "poses2d.npz", poses=p2)
    return tmp_path / "toolbox", preds


def test_panoptic_chain_feeds_the_loader(tmp_path):
    """toolbox JSON → preprocess_panoptic_gt → preprocess_metrabs_predictions
    → filter_preds_number_views → compute_initial_guess_panoptic
    --filtered_suffix _2 in both packages, then the port's DataLoader."""
    tb, preds = _panoptic_raw(tmp_path, np.random.default_rng(4))
    steps = [
        ("panoptic.preprocess_panoptic_gt",
         lambda r: ["--input", str(tb), "--sequences", PAN_SEQ,
                    "--output", r], ()),
        ("panoptic.preprocess_metrabs_predictions",
         lambda r: ["--input_dir", str(preds), "--output_dir", r,
                    "--activities", PAN_SEQ], ()),
        ("panoptic.filter_preds_number_views",
         lambda r: ["--data_path", r, "--activities", PAN_SEQ,
                    "--nviews", "2"], ()),
        ("panoptic.compute_initial_guess_panoptic",
         lambda r: ["--root_dir", r, "--filtered_suffix", "_2"],
         ("--device", "cpu")),
    ]
    roots = [tmp_path / "panoptic-jax", tmp_path / "panoptic-torch"]
    for name, argv, port_args in steps:
        jax_tool, port_tool = _tools(name)
        jax_tool.main(argv(str(roots[0])))
        port_tool.main([*argv(str(roots[1])), *port_args])
        assert_same_tree(*map(str, roots),
                         atol_under="initial_guess/metrabs")

    root = str(roots[1])
    fused = np.load(os.path.join(root, "initial_guess", "metrabs", "S0",
                                 PAN_SEQ, "poses.npz"))["poses3d"]
    assert fused.shape == (4, 19, 3) and np.isfinite(fused).all()
    loader = DataLoader(root, os.path.join(root, "initial_guess", "metrabs"),
                        os.path.join(root, "2d_metrabs"), frame_step=1,
                        nviews=2)
    recs = [r for _, r in loader]
    assert [r.scene_name for r in recs] == [
        f"S0_{PAN_SEQ}_{i:06d}" for i in range(4)]
    gt = np.load(os.path.join(root, "3d_gt", "S0", PAN_SEQ,
                              "poses_filtered_2.npz"))["poses"]
    for i, r in enumerate(recs):
        assert np.array_equal(r.pose_3d, fused[i].astype(np.float32))
        assert np.array_equal(r.pose_3d_gt, gt[i].astype(np.float32))
        assert r.poses_2d.shape == (2, 19, 2) and len(r.cameras) == 2
    # a convex combination of the two views: no joint further from the GT
    # (mm, after the filter's x10) than the worse view's
    mono = [np.load(os.path.join(root, "3d_metrabs_mono", "S0", PAN_SEQ, c,
                                 "poses_filtered_2.npz"))["poses"]
            for c in PANOPTIC_CAMERAS[:2]]
    worst = np.max([np.linalg.norm(p - gt, axis=-1) for p in mono], axis=0)
    assert (np.linalg.norm(fused - gt, axis=-1) <= worst + 1e-9).all()


# ---------------------- Occlusion-Person, triangulation ----------------------

def _op_raw(tmp_path, rng, frames=10):
    raw = tmp_path / "raw"
    raw.mkdir()
    data = [{"joints_2d": rng.normal(0, 300, (15, 3)),
             "joints_gt": rng.normal(0, 900, (15, 3)),
             "camera": {"R": rng.normal(size=(3, 3)), "T": rng.normal(size=3),
                        "fx": 1000.0 + i, "fy": 1001.0, "cx": 640.0,
                        "cy": 360.0, "name": f"cam{i % 8}"}}
            for i in range(8 * frames)]
    with open(raw / "annotations.pkl", "wb") as f:
        pickle.dump(data, f)
    np.savez(raw / "resnet.npz", preds=rng.normal(0, 300, (8 * frames, 15, 3)))
    return raw


@pytest.mark.parametrize("tool", [
    "occlusion_person.preprocess_occlusion_person_gt",
    "occlusion_person.preprocess_resnet_2d_poses"])
def test_occlusion_person_converters_match_jax(tmp_path, tool):
    raw = _op_raw(tmp_path, np.random.default_rng(5))
    arg = ["--pkl_file", str(raw / "annotations.pkl")] if tool.endswith(
        "_gt") else ["--input_file", str(raw / "resnet.npz")]
    a, b = _run_both(tool, tmp_path, lambda r: [*arg, "--output_dir", r])
    assert assert_same_tree(a, b) >= 8


@pytest.mark.parametrize("input_name", ["iteration_0", "cpn_iteration_0"])
def test_triangulation_guess_matches_jax(tmp_path, input_name):
    """Grouped by the first two ``_`` fields, sorted within a group, CPN's
    S11/Directions skipped; each frame bitwise the PLY's xyz."""
    rng = np.random.default_rng(6)
    src = tmp_path / input_name
    src.mkdir()
    names = ["S9_Directions_000064", "S9_Directions_000000",
             "S11_Directions_000000", "S11_Walking_000000",
             "S0_171204_pose5_000012", "S0_171204_pose6_000000"]
    for n in names:
        ply.write_xyz_double_ply(str(src / f"{n}.ply"),
                                 rng.normal(0, 900, (17 if n[1] != "0"
                                                     else 19, 3)))
    (src / "notes.txt").write_text("x")
    (src / "single.ply").write_bytes(b"")
    a, b = _run_both("preprocess_triang_initial_guess", tmp_path,
                     lambda r: ["--input_dir", str(src), "--output_dir", r,
                                "--name", "triang_x"])
    assert_same_tree(a, b)
    out = os.path.join(b, "initial_guess", "triang_x")
    assert os.path.isdir(os.path.join(out, "S11", "Directions")) == (
        input_name == "iteration_0")
    got = np.load(os.path.join(out, "S0", "171204", "poses.npz"))["poses3d"]
    want = [ply.read_xyz(str(src / f"{n}.ply")) for n in sorted(
        n for n in names if n.startswith("S0_"))]
    assert got.tobytes() == np.array(want).tobytes()


# --------------------------- small converters ------------------------------

def test_extract_poses_and_read_pkl_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(8)
    items = [{"poses3d_world": rng.normal(0, 900, (17, 3)).tolist()}
             for _ in range(5)]
    (tmp_path / "preds.json").write_text(json.dumps(items))
    a, b = _run_both("extract_poses_from_json", tmp_path,
                     lambda r: [str(tmp_path / "preds.json"), r])
    assert assert_same_tree(a, b) == 1
    for obj in ({"a": np.arange(3), "b": [1, 2]}, [np.ones(2), "x"]):
        with open(tmp_path / "x.pkl", "wb") as f:
            pickle.dump(obj, f)
        outs = []
        for mod in _tools("read_pkl"):
            capsys.readouterr()
            mod.main(["--file_path", str(tmp_path / "x.pkl")])
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and outs[0], outs


@pytest.mark.parametrize("mode", ["2d", "3d"])
def test_check_dataset_pngs_match_jax(tmp_path, mode):
    pytest.importorskip("matplotlib", reason="check_dataset draws with "
                        "matplotlib, which it imports only when it runs")
    rng = np.random.default_rng(9)
    for tree, key in (("gt", "poses"), ("pred", "poses2d" if mode == "2d"
                                        else "poses3d")):
        d = tmp_path / tree / "S9" / "Walking"
        if mode == "2d":
            d = d / H36M_CAMERAS[0]
        d.mkdir(parents=True)
        np.savez(d / "poses.npz", **{key: rng.normal(
            0, 400, (3, 17, 2 if mode == "2d" else 3))})
    a, b = _run_both("check_dataset", tmp_path, lambda r: [
        mode, "--gt_dir", str(tmp_path / "gt"), "--pred_dir",
        str(tmp_path / "pred"), "--out_dir", r, "--max_frames", "2"])
    assert assert_same_tree(a, b) == 2


def test_make_depth_scale_matches_jax(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2", reason="make_depth_scale samples the "
                              "depth maps with cv2.remap, imported only when "
                              "it runs")
    # OpenCV 5 returns (1, n) for 1-D maps, where both tools take the (n, 1)
    # of older releases and keep column 0: one sample, a zero mono spread
    # and an infinite scale whatever the arithmetic. Hand both packages the
    # (n, 1) layout so that their median/MAD scales and offsets are finite
    remap = cv2.remap
    monkeypatch.setattr(cv2, "remap",
                        lambda *a, **k: remap(*a, **k).reshape(-1, 1))
    rng = np.random.default_rng(10)
    base = tmp_path / "scene"
    (base / "sparse" / "0").mkdir(parents=True)
    (tmp_path / "depths").mkdir()
    w, h, n_pts = 64, 48, 40
    xyz = rng.normal(0, 1, (n_pts, 3)) + [0, 0, 6]
    colmap.write_cameras_binary({1: colmap.Camera(1, "PINHOLE", w, h,
                                                  [50.0, 50.0, 32.0, 24.0])},
                                str(base / "sparse" / "0" / "cameras.bin"))
    images = {}
    for i in range(3):
        ids = rng.permutation(n_pts + 5) - 3      # some invalid ids
        images[i + 1] = colmap.Image(
            i + 1, np.array([1.0, 0, 0, 0]), rng.normal(0, 0.1, 3), 1,
            f"img{i}.jpg", rng.uniform(-2, w + 2, (len(ids), 2)), ids)
        depth = rng.integers(1, 2 ** 16, (h, w)).astype(np.uint16)
        if i < 2:   # the third image has no depth map
            cv2.imwrite(str(tmp_path / "depths" / f"img{i}.png"), depth)
    colmap.write_images_binary(images, str(base / "sparse" / "0" /
                                           "images.bin"))
    colmap.write_points3D_binary(
        {j: colmap.Point3D(j, xyz[j], [1, 2, 3], 0.5, [1], [0])
         for j in range(n_pts)}, str(base / "sparse" / "0" / "points3D.bin"))
    a, b = _run_both("make_depth_scale", tmp_path, lambda r: [
        "--base_dir", r, "--depths_dir", str(tmp_path / "depths")], src=base)
    assert_same_tree(a, b)
    with open(os.path.join(b, "sparse", "0", "depth_params.json")) as f:
        params = json.load(f)
    # one entry per image with a depth map, each from all its samples
    assert sorted(params) == ["img0", "img1"], params
    for p in params.values():
        assert np.isfinite([p["scale"], p["offset"]]).all(), params
        assert p["scale"] != 0, params
