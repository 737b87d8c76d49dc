"""The port's upstream-3DGS compatibility surface against the JAX
package's, on the CPU: kNN, spherical harmonics, the file helpers of
``utils``, COLMAP IO, the camera and scene readers, ``GaussianModel`` and
``Scene``, densification and the renderer registry.

Bars: numpy-only modules (COLMAP, readers, densification on the host)
equal or bitwise; kNN within rtol 1e-4 / atol 1e-5 of brute force (the
JAX package's own bar: ‖a‖² + ‖b‖² − 2a·b cancels) and 1e-6 relative of
JAX's; SH within 1e-6; an Adam step within 1e-6 relative."""

import json
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from skelsplat_tpu import compat as jcompat
from skelsplat_tpu import renderer_registry as jreg
from skelsplat_tpu import utils as jutils
from skelsplat_tpu.core.gaussians import GaussianParams as JParams
from skelsplat_tpu.data import camera_utils as jcu
from skelsplat_tpu.data import colmap as jcolmap
from skelsplat_tpu.data.cameras_io import CameraInfo as JCameraInfo
from skelsplat_tpu.data import scene_readers as jsr
from skelsplat_tpu.engine.optim import AdamState as JAdamState
from skelsplat_tpu.ops import densify as jdensify
from skelsplat_tpu.ops import knn as jknn
from skelsplat_tpu.ops import sh as jsh
from skelsplat_tpu_torch import compat, native, renderer_registry, utils
from skelsplat_tpu_torch.core import cameras as tcameras
from skelsplat_tpu_torch.core.gaussians import PARAM_FIELDS, GaussianParams
from skelsplat_tpu_torch.data import camera_utils, colmap, scene_readers
from skelsplat_tpu_torch.data.cameras_io import CameraInfo
from skelsplat_tpu_torch.engine.optim import AdamState
from skelsplat_tpu_torch.ops import densify, knn, sh
from tests.utils import synthetic_skeleton

KNN_RTOL, KNN_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run the port's CPU ops on one torch thread: under the test run's
    parallel workers, an intra-op thread per core in every worker contends
    for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _brute_mean3(pts):
    d2 = ((pts[:, None].astype(np.float64) - pts[None, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.sort(d2, axis=1)[:, :3].mean(1)


@pytest.mark.parametrize("tile", [64, 2048])
def test_knn_matches_jax_and_brute_force(tile):
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 1, (257, 3)).astype(np.float32)
    pts[5] = pts[9]   # a duplicate point is a neighbour at distance 0
    ours = knn.knn_mean_sq_dist(torch.from_numpy(pts), tile=tile).numpy()
    ref = _brute_mean3(pts)
    np.testing.assert_allclose(ours, ref, rtol=KNN_RTOL, atol=KNN_ATOL)
    jax_d = np.asarray(jknn.knn_mean_sq_dist(pts, tile=tile))
    np.testing.assert_allclose(ours, jax_d, rtol=1e-6, atol=KNN_ATOL)
    np.testing.assert_array_equal(
        knn.dist2_mean3nn(torch.from_numpy(pts)).numpy(),
        knn.knn_mean_sq_dist(torch.from_numpy(pts)).numpy())
    np.testing.assert_allclose(
        knn.knn_scale_init(torch.from_numpy(pts)).numpy(),
        np.asarray(jknn.knn_scale_init(pts)), rtol=1e-5, atol=1e-5)
    # fewer than k other points: +inf, as JAX gives
    two = torch.from_numpy(pts[:3])
    assert torch.isinf(knn.knn_mean_sq_dist(two, k=3)).all()
    assert np.isinf(np.asarray(jknn.knn_mean_sq_dist(pts[:3], k=3))).all()
    # the native Morton-boxed search over the same points
    np.testing.assert_allclose(native.knn_mean3_sq(pts), ref,
                               rtol=KNN_RTOL, atol=KNN_ATOL)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    shs = rng.normal(size=(5, 3, (deg + 1) ** 2)).astype(np.float32)
    dirs = rng.normal(size=(5, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ours = sh.eval_sh(deg, torch.from_numpy(shs), torch.from_numpy(dirs))
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(jsh.eval_sh(deg, shs, dirs)),
                               rtol=1e-6, atol=1e-6)
    rgb = torch.from_numpy(rng.random((5, 3)).astype(np.float32))
    np.testing.assert_allclose(sh.SH2RGB(sh.RGB2SH(rgb)).numpy(),
                               rgb.numpy(), atol=1e-6)
    np.testing.assert_allclose(sh.RGB2SH(rgb).numpy(),
                               np.asarray(jsh.RGB2SH(rgb.numpy())),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        sh.eval_sh(deg + 1, torch.from_numpy(shs), torch.from_numpy(dirs))


def test_file_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    for mode, shape in (("RGB", (6, 5, 3)), ("L", (6, 5))):
        im = PILImage.fromarray(rng.integers(0, 256, shape, dtype=np.uint8),
                                mode)
        np.testing.assert_array_equal(utils.pil_to_array(im),
                                      jutils.pil_to_array(im))
    utils.mkdir_p(str(tmp_path / "a" / "b"))
    utils.mkdir_p(str(tmp_path / "a" / "b"))
    for it in (7, 30, 12):
        utils.mkdir_p(str(tmp_path / "a" / f"iteration_{it}"))
    os.rmdir(tmp_path / "a" / "b")
    folder = str(tmp_path / "a")
    assert utils.searchForMaxIteration(folder) == \
        jutils.searchForMaxIteration(folder) == 30


def _colmap_model(mod, ext):
    """A small model in the ``mod`` package's record types: PINHOLE cameras
    (and, in binary, a SIMPLE_PINHOLE one), posed images with 2D points,
    and 3D points with tracks."""
    rng = np.random.default_rng(1)
    cams = {1: mod.Camera(1, "PINHOLE", 640, 480,
                          np.array([500.0, 510.0, 320.0, 240.0])),
            2: mod.Camera(2, "PINHOLE", 320, 200,
                          np.array([250.5, 251.0, 160.0, 100.0]))}
    if ext == ".bin":
        cams[3] = mod.Camera(3, "SIMPLE_PINHOLE", 400, 300,
                             np.array([333.0, 200.0, 150.0]))
    images = {}
    for i, cid in enumerate(cams, start=1):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q) * np.sign(q[0])
        images[i] = mod.Image(
            id=i, qvec=q, tvec=rng.normal(0, 2, 3), camera_id=cid,
            name=f"img_{i:03d}.png", xys=rng.uniform(0, 200, (3, 2)),
            point3D_ids=np.array([1, 2, -1]))
    points = {pid: mod.Point3D(
        id=pid, xyz=rng.normal(0, 1, 3), rgb=rng.integers(0, 256, 3),
        error=np.array(rng.uniform()), image_ids=np.array([1, 2]),
        point2D_idxs=np.array([0, pid - 1])) for pid in (1, 2, 3)}
    return cams, images, points


def _same_model(a, b):
    for da, db in zip(a, b):
        assert sorted(da) == sorted(db)
        for k in da:
            for fa, fb in zip(da[k], db[k]):
                if isinstance(fa, np.ndarray) or isinstance(fb, np.ndarray):
                    np.testing.assert_array_equal(np.asarray(fa),
                                                  np.asarray(fb))
                else:
                    assert fa == fb


@pytest.fixture(params=[".txt", ".bin"])
def colmap_scene(request, tmp_path):
    """A COLMAP scene dir (``sparse/0``) written by the port."""
    ext = request.param
    model = _colmap_model(colmap, ext)
    sparse = tmp_path / "scene" / "sparse" / "0"
    sparse.mkdir(parents=True)
    colmap.write_model(*model, str(sparse), ext=ext)
    return ext, str(tmp_path / "scene"), str(sparse), model


def test_colmap_round_trip_in_both_packages(colmap_scene, tmp_path):
    ext, _, sparse, model = colmap_scene
    assert colmap.detect_model_format(sparse, ext)
    assert not colmap.detect_model_format(sparse, ".bin" if ext == ".txt"
                                          else ".txt")
    ours, theirs = colmap.read_model(sparse), jcolmap.read_model(sparse)
    _same_model(ours, model)
    _same_model(theirs, model)
    # JAX writes the same model: the port reads it back, byte for byte
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jcolmap.write_model(*_colmap_model(jcolmap, ext), str(jdir), ext=ext)
    for name in ("cameras", "images", "points3D"):
        with open(os.path.join(sparse, name + ext), "rb") as f, \
                open(jdir / (name + ext), "rb") as g:
            assert f.read() == g.read(), name
    _same_model(colmap.read_model(str(jdir), ext), model)
    xyz, rgb, err = colmap.read_points3D_text(os.path.join(
        sparse, "points3D.txt")) if ext == ".txt" else \
        colmap.read_points3D_binary(os.path.join(sparse, "points3D.bin"))
    np.testing.assert_array_equal(xyz, np.stack(
        [p.xyz for p in model[2].values()]))
    with pytest.raises(FileNotFoundError):
        colmap.read_model(str(tmp_path))


def _same_cameras(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert (a.uid, a.width, a.height) == (b.uid, b.width, b.height)
        for f in ("R", "T", "K"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _same_scene_info(ours, theirs):
    _same_cameras(ours.train_cameras, theirs.train_cameras)
    _same_cameras(ours.test_cameras, theirs.test_cameras)
    np.testing.assert_array_equal(ours.nerf_normalization["translate"],
                                  theirs.nerf_normalization["translate"])
    assert ours.nerf_normalization["radius"] == \
        theirs.nerf_normalization["radius"]
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(ours.point_cloud, f),
                                      getattr(theirs.point_cloud, f))
    assert ours.is_nerf_synthetic == theirs.is_nerf_synthetic


def test_colmap_scene_reader_matches_jax(colmap_scene):
    ext, scene, sparse, model = colmap_scene
    ours = scene_readers.readColmapSceneInfo(scene, eval=True, llffhold=2)
    os.remove(os.path.join(sparse, "points3D.ply"))
    theirs = jsr.readColmapSceneInfo(scene, eval=True, llffhold=2)
    _same_scene_info(ours, theirs)
    assert len(ours.test_cameras) == (len(model[0]) + 1) // 2
    np.testing.assert_array_equal(ours.point_cloud.points, np.stack(
        [p.xyz for p in model[2].values()]).astype(np.float32))
    # the loader-convention cameras become the same Camera in both
    for args in (types.SimpleNamespace(resolution=-1),
                 types.SimpleNamespace(resolution=2),
                 types.SimpleNamespace(resolution=160)):
        tc = camera_utils.cameraList_from_camInfos(
            ours.train_cameras, 1.0, args, device="cpu")
        jc = jcu.cameraList_from_camInfos(theirs.train_cameras, 1.0, args)
        for a, b in zip(tc, jc):
            for f in tcameras.FIELDS:
                np.testing.assert_array_equal(
                    getattr(a, f).numpy(), np.asarray(getattr(b, f)), f)
    for i, c in enumerate(ours.train_cameras):
        assert camera_utils.camera_to_JSON(i, c) == jcu.camera_to_JSON(
            i, theirs.train_cameras[i])


def test_pose_and_blender_scene_readers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    pose = rng.normal(0, 500, (17, 3)).astype(np.float32)
    cams = []
    for uid in range(4):
        q = rng.normal(size=4)
        cams.append(CameraInfo(uid=uid, R=colmap.qvec2rotmat(q / np.linalg.norm(q)),
                               T=rng.normal(0, 3000, 3),
                               K=np.array([[1100.0, 0, 500], [0, 1100, 500],
                                           [0, 0, 1]]),
                               width=1002, height=1000))
    for name in ("Human36M", "Panoptic", "Occlusion-Person"):
        ours = scene_readers.sceneLoadTypeCallbacks[name](
            str(tmp_path / "port"), pose, cams, "S9_Walking_000064")
        theirs = jsr.sceneLoadTypeCallbacks[name](
            str(tmp_path / "jax"), pose, cams, "S9_Walking_000064")
        _same_scene_info(ours, theirs)
        assert ours.scene_name == theirs.scene_name
        with open(ours.ply_path, "rb") as f, open(theirs.ply_path, "rb") as g:
            assert f.read() == g.read()

    blender = tmp_path / "blender"
    blender.mkdir()
    for split, n in (("train", 3), ("test", 2)):
        frames = []
        for i in range(n):
            q = np.array([1.0, *rng.normal(0, 0.2, 3)])
            c2w = np.eye(4)
            c2w[:3, :3] = colmap.qvec2rotmat(q / np.linalg.norm(q))
            c2w[:3, 3] = rng.normal(0, 4, 3)
            frames.append({"transform_matrix": c2w.tolist()})
        with open(blender / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    scene_readers.storePly(str(blender / "points3d.ply"),
                           rng.normal(0, 1, (50, 3)),
                           rng.integers(0, 256, (50, 3)))
    for ev in (False, True):
        _same_scene_info(scene_readers.readNerfSyntheticInfo(str(blender),
                                                             eval=ev),
                         jsr.readNerfSyntheticInfo(str(blender), eval=ev))


def _training_args():
    return types.SimpleNamespace(
        iterations=500, position_lr_init=0.5, position_lr_final=0.005,
        position_lr_delay_mult=0.0, position_lr_max_steps=500,
        feature_lr=0.0, opacity_lr=0.05, scaling_lr=0.005, rotation_lr=0.001)


def test_gaussian_model_and_scene_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    pose = synthetic_skeleton(17, rng).astype(np.float32)
    cams = []
    for uid in range(4):
        th = 2 * np.pi * uid / 4
        z = -np.array([np.cos(th), np.sin(th), 0.0])
        x = np.cross([0.0, 0.0, -1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        cams.append(CameraInfo(uid=uid, R=R.T, T=-R @ (-4000 * z + [0, 0, 800]),
                               K=np.array([[1100.0, 0, 60], [0, 1100, 56],
                                           [0, 0, 1]]),
                               width=120, height=112))
    dataset = types.SimpleNamespace(data_root="/data/synth-h36m")
    model = types.SimpleNamespace(scaling=3.0, scaling_modifier=1.5,
                                  opacity_on=True)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    g = compat.GaussianModel(device="cpu")
    scene = compat.Scene(dataset, model, g, pose, cams, "S9_Walking_000064",
                         str(port_dir))
    jg = jcompat.GaussianModel()
    jscene = jcompat.Scene(dataset, model, jg, pose,
                           [JCameraInfo(**vars(c)) for c in cams],
                           "S9_Walking_000064", str(jax_dir))
    for name in ("input.ply", "cameras.json",
                 os.path.join("sparse", "points3D.ply")):
        with open(port_dir / name, "rb") as f, open(jax_dir / name, "rb") as h:
            assert f.read() == h.read(), name
    np.testing.assert_allclose(scene.cameras_extent, jscene.cameras_extent,
                               rtol=1e-12)
    assert scene.n_joints == jscene.n_joints == 17
    for f in tcameras.FIELDS:
        np.testing.assert_array_equal(
            getattr(scene.getTrainCameras(), f).numpy(),
            np.asarray(getattr(jscene.getTrainCameras(), f)), f)
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(g.params, f).numpy(),
                                      np.asarray(getattr(jg.params, f)), f)
    np.testing.assert_array_equal(g.get_features.numpy(),
                                  np.asarray(jg.get_features))
    np.testing.assert_allclose(g.get_covariance(1.2).numpy(),
                               np.asarray(jg.get_covariance(1.2)), rtol=1e-6)

    g.training_setup(_training_args())
    jg.training_setup(_training_args())
    for it in (1, 2, 3):
        grads = {f: rng.normal(0, 1, tuple(getattr(g.params, f).shape)
                               ).astype(np.float32) for f in PARAM_FIELDS}
        assert g.update_learning_rate(it) == pytest.approx(
            jg.update_learning_rate(it), rel=1e-6)
        g.step(GaussianParams(*(torch.from_numpy(grads[f])
                                for f in PARAM_FIELDS)), it)
        jg.step(JParams(**grads), it)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(g.params, f).numpy(),
                                   np.asarray(getattr(jg.params, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert int(g.opt_state.t) == int(jg.opt_state.t) == 3

    # save in one package, load in the other
    scene.save_h36m(3, "S9_Walking_000064")
    jscene.save(3)
    g2, jg2 = compat.GaussianModel(device="cpu"), jcompat.GaussianModel()
    g2.load_ply(str(jax_dir / "point_cloud" / "iteration_3"
                    / "point_cloud.ply"))
    jg2.load_ply(str(port_dir / "point_cloud" / "iteration_3"
                     / "S9_Walking_000064.ply"))
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(g2.params, f).numpy(),
                                      np.asarray(getattr(jg.params, f)))
        np.testing.assert_array_equal(np.asarray(getattr(jg2.params, f)),
                                      getattr(g.params, f).numpy())
    assert g2.active_sh_degree == g2.max_sh_degree == 1
    # a Scene that loads its latest saved iteration
    os.rename(port_dir / "point_cloud" / "iteration_3" / "S9_Walking_000064.ply",
              port_dir / "point_cloud" / "iteration_3" / "point_cloud.ply")
    g3 = compat.GaussianModel(device="cpu")
    s3 = compat.Scene(dataset, model, g3, pose, cams, "S9_Walking_000064",
                      str(port_dir), load_iteration=-1)
    assert s3.loaded_iter == 3
    np.testing.assert_array_equal(g3.get_xyz.numpy(), g.get_xyz.numpy())


def _densify_inputs():
    """Params, Adam moments and statistics of 12 Gaussians in both
    packages: some clone (high gradient, small), some split (high
    gradient, large), two are transparent, one is oversized on screen."""
    rng = np.random.default_rng(4)
    n = 12
    p = {"xyz": rng.normal(0, 1, (n, 3)).astype(np.float32),
         "log_scales": np.log(rng.uniform(0.001, 0.05, (n, 3))).astype(
             np.float32),
         "quats": rng.normal(0, 1, (n, 4)).astype(np.float32),
         "opacity_logit": rng.normal(0, 2, (n, 1)).astype(np.float32)}
    p["log_scales"][[1, 4, 7]] = np.log(0.2)        # large: split
    p["opacity_logit"][[2, 9]] = -8.0               # transparent: pruned
    m = {k: rng.normal(0, 0.1, v.shape).astype(np.float32)
         for k, v in p.items()}
    v = {k: rng.uniform(0, 0.1, val.shape).astype(np.float32)
         for k, val in p.items()}
    aux = densify.DensifyAux.zeros(n)
    jaux = jdensify.DensifyAux.zeros(n)
    vg = rng.normal(0, 0.001, (n, 3)).astype(np.float32)
    vg[[0, 1, 3, 4], 0] = [0.2, -0.15, 0.1, 0.3]    # high gradient
    radii = rng.uniform(1, 10, n).astype(np.float32)
    radii[5] = 80.0                                 # oversized
    vis = np.ones(n, bool)
    vis[11] = False
    for _ in range(2):
        aux = densify.add_densification_stats(
            aux, torch.from_numpy(vg), torch.from_numpy(radii),
            torch.from_numpy(vis))
        jaux = jdensify.add_densification_stats(jaux, vg, radii, vis)
    for f in ("xyz_gradient_accum", "denom", "max_radii2D"):
        np.testing.assert_array_equal(getattr(aux, f), getattr(jaux, f))
    tp = GaussianParams(*(torch.from_numpy(p[k]) for k in PARAM_FIELDS))
    ts = AdamState(m=GaussianParams(*(torch.from_numpy(m[k])
                                      for k in PARAM_FIELDS)),
                   v=GaussianParams(*(torch.from_numpy(v[k])
                                      for k in PARAM_FIELDS)),
                   t=torch.tensor(5, dtype=torch.int32))
    jp = JParams(**p)
    js = JAdamState(m=JParams(**m), v=JParams(**v), t=np.int32(5))
    return (tp, ts, aux), (jp, js, jaux), radii


def _same_state(tp, ts, jp, js):
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), f)
        np.testing.assert_array_equal(getattr(ts.m, f).numpy(),
                                      np.asarray(getattr(js.m, f)), f)
        np.testing.assert_array_equal(getattr(ts.v, f).numpy(),
                                      np.asarray(getattr(js.v, f)), f)
    assert int(ts.t) == int(np.asarray(js.t))


@pytest.mark.parametrize("max_screen_size", [None, 20.0])
def test_densify_and_prune_match_jax(max_screen_size):
    (tp, ts, aux), (jp, js, jaux), radii = _densify_inputs()
    kw = dict(max_grad=0.05, min_opacity=0.005, extent=5.0,
              max_screen_size=max_screen_size)
    p2, s2, aux2 = densify.densify_and_prune(
        tp, ts, aux, radii=torch.from_numpy(radii),
        rng=np.random.default_rng(11), **kw)
    jp2, js2, _ = jdensify.densify_and_prune(
        jp, js, jaux, radii=radii, rng=np.random.default_rng(11), **kw)
    _same_state(p2, s2, jp2, js2)
    # 2 clones (0, 3), 2 split parents (1, 4) → 4 children, 2 and 9
    # pruned (and, with max_screen_size, 5)
    n_expected = 12 + 2 + 4 - 2 - 2 - (1 if max_screen_size else 0)
    assert p2.xyz.shape == (n_expected, 3)
    assert aux2.denom.shape == (n_expected, 1) and not aux2.denom.any()
    assert all(getattr(s2.m, f).shape[0] == n_expected
               for f in PARAM_FIELDS)

    p3, s3 = densify.reset_opacity(p2, s2)
    jp3, js3 = jdensify.reset_opacity(jp2, js2)
    _same_state(p3, s3, jp3, js3)
    assert (torch.sigmoid(p3.opacity_logit) <= 0.01 + 1e-6).all()
    assert not s3.m.opacity_logit.any() and not s3.v.opacity_logit.any()
    assert torch.equal(s3.m.xyz, s2.m.xyz)


def test_renderer_registry_matches_jax_channels():
    assert renderer_registry.RENDERING_CHANNELS == jreg.RENDERING_CHANNELS
    assert sorted(renderer_registry.render_functions) == \
        sorted(jreg.render_functions)
    rng = np.random.default_rng(5)
    K = np.array([[90.0, 0, 24], [0, 90, 20], [0, 0, 1]])
    cam = tcameras.make_camera(np.eye(3), np.array([0.0, 0.0, 5.0]), K, 48,
                               40, device="cpu")
    for key, n in renderer_registry.RENDERING_CHANNELS.items():
        fn = renderer_registry.render_functions[key]
        g = compat.GaussianModel(device="cpu")
        g.params = GaussianParams(
            torch.from_numpy(rng.normal(0, 0.3, (n, 3)).astype(np.float32)),
            torch.full((n, 3), np.log(0.05)), torch.eye(n, 4) + 1.0,
            torch.full((n, 1), 2.0))
        out = fn(cam, g)
        assert out["render"].shape == (n, 40, 48)
        assert out["render"].max() > 0
        assert out["viewspace_points"].shape == (n, 3)
        assert out["radii"].shape == out["visibility_filter"].shape == (n,)
        assert out["depth"].shape == (40, 48)
        colors = torch.from_numpy(rng.random((n, 3)).astype(np.float32))
        rgb = fn(cam, g.params, override_color=colors)["render"]
        assert rgb.shape == (3, 40, 48)
        np.testing.assert_allclose(
            rgb.numpy(),
            torch.clamp(torch.einsum("nhw,nc->chw", out["render"], colors),
                        0, 1).numpy(), atol=1e-5)
        other = [f for k, f in renderer_registry.render_functions.items()
                 if renderer_registry.RENDERING_CHANNELS[k] != n][0]
        with pytest.raises(ValueError, match="channels"):
            other(cam, g)
