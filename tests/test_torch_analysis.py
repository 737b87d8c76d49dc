"""The port's analysis and tool modules against the JAX package on the same
numpy-seeded inputs: the GT heatmap extras (one channel, the scipy oracle,
the keyed dropout draw), ``analysis``, ``tools/analyze_confidence``,
``network_gui``, ``arguments``, ``tools/ab_harness``,
``tools/parity_study`` and ``viz``."""

import argparse
import json
import math
import os
import socket
import struct
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skelsplat_tpu import analysis as janalysis
from skelsplat_tpu import arguments as jarguments
from skelsplat_tpu import network_gui as jgui
from skelsplat_tpu.core.gaussians import init_params as jinit_params
from skelsplat_tpu.data.loader import DataLoader as JLoader
from skelsplat_tpu.ops import heatmaps as jhm
from skelsplat_tpu.tools import ab_harness as jab
from skelsplat_tpu.tools import analyze_confidence as jconf
from skelsplat_tpu_torch import analysis, arguments, compat, network_gui, viz
from skelsplat_tpu_torch.core.cameras import FIELDS as CAM_FIELDS
from skelsplat_tpu_torch.core.gaussians import SkeletonModel, init_params
from skelsplat_tpu_torch.data import ply
from skelsplat_tpu_torch.data.loader import DataLoader
from skelsplat_tpu_torch.engine.optim import OptConfig
from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings
from skelsplat_tpu_torch.ops import heatmaps as thm
from skelsplat_tpu_torch.tools import ab_harness, analyze_confidence
from skelsplat_tpu_torch.tools import make_synthetic_dataset, parity_study
from tests.utils import project_np, synthetic_rig, synthetic_skeleton, take_cam

N_J, NV = 17, 3
W, H = 96, 80


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops on one torch thread (the tier-1 run's
    parallel workers would contend for the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene():
    """(JAX cameras, the port's cameras, initial pose, detections, a
    dropout mask) of one 3-view scene."""
    cams, _, _ = synthetic_rig(n_views=NV, width=W, height=H)
    rng = np.random.default_rng(6)
    pts = synthetic_skeleton(N_J, rng=rng, spread=300.0)
    p2d = np.stack([project_np(pts, take_cam(cams, v)) for v in range(NV)])
    p2d = (p2d + rng.normal(0, 1.5, p2d.shape)).astype(np.float32)
    drop = np.zeros((NV, N_J), bool)
    drop[[0, 2], 5] = True
    drop[1, 11] = True
    tcams = compat.camera_from_numpy(jax.tree.map(np.asarray, cams),
                                     device="cpu")
    return cams, tcams, pts, p2d, drop


def _assert_within_scale(ours, ref, rel=1e-6, err_msg=""):
    """|ours − ref| ≤ rel · max|ref|: float32 covariances are sums of
    products of ~1e2 that cancel to small off-diagonal terms, so the two
    packages' different operation orders part them by ~1 ulp of the
    matrix's scale, not of each element."""
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rel * np.abs(ref).max(), err_msg=err_msg)


def _covs(pts):
    jp = jinit_params(pts, "h36m", scaling=3.0)
    tp = init_params(pts, "h36m", 3.0, device="cpu")
    return jp, tp


@pytest.mark.parametrize("dropped", [False, True])
def test_eval_heatmap_channel_matches_jax(scene, dropped):
    cams, tcams, pts, p2d, drop = scene
    drop = drop if dropped else None
    jp, tp = _covs(pts)
    spec = jhm.heatmap_spec(jp.xyz, jp.covariance(), jnp.asarray(p2d), cams,
                            W, H, drop_mask=drop)
    tspec = thm.heatmap_spec(tp.xyz, tp.covariance(), torch.as_tensor(p2d),
                             tcams, W, H, drop_mask=drop)
    full = thm.eval_heatmaps(tspec, W, H)
    ys, xs = torch.arange(H)[:, None], torch.arange(W)[None, :]
    for v, j in ((0, 5), (1, 4), (2, 16)):
        ours = thm.eval_heatmap_channel(tspec, v, j, ys, xs, W, H).numpy()
        ref = np.asarray(jhm.eval_heatmap_channel(
            spec, v, j, jnp.arange(H)[:, None], jnp.arange(W)[None, :], W, H))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(ours, full[v, j].numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("dropped", [False, True])
def test_scipy_oracle_matches_jax(scene, dropped):
    """The scipy oracle of the port against JAX's, and the port's closed
    form against it at JAX's own bar (tests/test_heatmaps.py)."""
    cams, tcams, pts, p2d, drop = scene
    drop = drop if dropped else None
    jp, tp = _covs(pts)
    ours = thm.generate_heatmaps_scipy(tp.xyz, tp.covariance(), p2d, tcams,
                                       W, H, drop_mask=drop)
    ref = jhm.generate_heatmaps_scipy(jp.xyz, jp.covariance(), p2d, cams, W,
                                      H, drop_mask=drop)
    assert ours.shape == (NV, N_J, H, W) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    closed = thm.eval_heatmaps(
        thm.heatmap_spec(tp.xyz, tp.covariance(), torch.as_tensor(p2d),
                         tcams, W, H, drop_mask=drop), W, H).numpy()
    assert np.abs(closed - ours).max() < 2e-5


def test_keyed_dropout_masks():
    """Shape, dtype, the same masks from the same seed (and the host
    draw's), 3 cameras × 3 joints at most, and each view's keep rate
    against JAX's keyed draw over 2000 scenes."""
    n, draws = 4, 2000
    gen = torch.Generator().manual_seed(3)
    masks = torch.stack([thm.dropout_masks(gen, n, N_J)
                         for _ in range(draws)])
    assert masks.shape == (draws, n, N_J) and masks.dtype == torch.bool
    again = thm.dropout_masks(torch.Generator().manual_seed(3), n, N_J)
    assert torch.equal(again, masks[0])
    host = thm.dropout_masks_torch(n, N_J, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(host, masks[0].numpy())
    assert ((masks.any(-1).sum(-1) <= 3) & (masks.any(-2).sum(-1) <= 3)).all()
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    jmasks = np.asarray(jax.vmap(lambda k: jhm.dropout_masks(k, n, N_J))(keys))
    keep = 1 - masks.float().mean(dim=(0, 2)).numpy()
    np.testing.assert_allclose(keep, 1 - jmasks.mean(axis=(0, 2)), atol=0.02)
    # a view is hit with probability 1 − (3/4)³ and then loses 1-3 joints
    assert (np.abs(keep - 0.9) < 0.03).all()


def test_host_inputs_draws_dropout_from_a_generator(scene):
    cams, tcams, pts, p2d, _ = scene
    trainer = SceneTrainer(SkeletonModel("h36m", N_J, scaling=3.0),
                           OptConfig(iterations=4),
                           TrainSettings(dropout=True), W, H, device="cpu")
    drop = trainer.host_inputs(pts, p2d, tcams,
                               drop_generator=torch.Generator().manual_seed(1))[4]
    assert torch.equal(drop, thm.dropout_masks(
        torch.Generator().manual_seed(1), NV, N_J))
    off = SceneTrainer(SkeletonModel("h36m", N_J, scaling=3.0),
                       OptConfig(iterations=4), TrainSettings(), W, H,
                       device="cpu")
    assert not off.host_inputs(pts, p2d, tcams,
                               drop_generator=torch.Generator())[4].any()


def test_sigma_coverage_matches_jax():
    rng = np.random.default_rng(8)
    means = rng.normal(0, 100, (5, N_J, 3))
    a = rng.normal(0, 1, (5, N_J, 3, 3))
    covs = a @ np.swapaxes(a, -1, -2) * 900 + np.eye(3) * 100
    gt = means + rng.normal(0, 40, means.shape)
    names = [f"j{i}" for i in range(N_J)]
    assert analysis.percent_inside_sigmas(
        means.reshape(-1, 3), covs.reshape(-1, 3, 3), gt.reshape(-1, 3)) == \
        janalysis.percent_inside_sigmas(means.reshape(-1, 3),
                                        covs.reshape(-1, 3, 3),
                                        gt.reshape(-1, 3))
    assert analysis.percent_inside_sigmas_per_joint(means, covs, gt, names) \
        == janalysis.percent_inside_sigmas_per_joint(means, covs, gt, names)


@pytest.fixture(scope="module")
def ply_tree(tmp_path_factory):
    """A 4-scene synthetic H36M tree and a run dir whose result PLYs hold
    its GT poses moved 20 mm and scaled and rotated at random; scene 3's
    cloud lies under an earlier (stop) iteration."""
    base = tmp_path_factory.mktemp("conf")
    root = str(base / "synth-h36m")
    assert make_synthetic_dataset.write_tree(root, ["S9", "S11"], 64, 64,
                                             image_size=W) == 4
    loader = DataLoader(root, os.path.join(root, "initial_guess", "metrabs"),
                        os.path.join(root, "2d_metrabs"), end_id=4)
    run = base / "run"
    rng = np.random.default_rng(2)
    for i, (_, rec) in enumerate(loader):
        it = 12 if i == 3 else 24
        ply.write_gaussian_ply(
            str(run / "point_cloud" / f"iteration_{it}"
                / f"{rec.scene_name}.ply"),
            (rec.pose_3d_gt + rng.normal(0, 20, (N_J, 3))).astype(np.float32),
            rng.normal(2.5, 0.4, (N_J, 3)).astype(np.float32),
            rng.normal(0, 1, (N_J, 4)).astype(np.float32),
            np.full((N_J, 1), 40.0, np.float32))
    jloader = JLoader(root, os.path.join(root, "initial_guess", "metrabs"),
                      os.path.join(root, "2d_metrabs"), end_id=4)
    return str(run), loader, jloader, root


def _plys(run):
    return [os.path.join(d, f) for d, _, fs in os.walk(run) for f in sorted(fs)
            if f.endswith(".ply")]


def test_cov_from_ply_and_correlation_match_jax(ply_tree):
    run, loader, _, _ = ply_tree
    paths = sorted(_plys(run))
    for p in paths:
        for ours, ref in zip(analysis.gaussian_cov_from_ply(p),
                             janalysis.gaussian_cov_from_ply(p)):
            for a, b in zip(ours, ref):     # joint by joint
                _assert_within_scale(a, b)
    gts = {rec.scene_name: rec.pose_3d_gt for _, rec in loader}
    gt = [gts[os.path.basename(p)[:-4]] for p in paths]
    ours = analysis.error_confidence_correlation(paths, gt)
    ref = janalysis.error_confidence_correlation(paths, gt)
    for k in ("errors", "confidences", "correlation"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6)


def test_scene_lambdas_match_jax(scene):
    cams, tcams, pts, _, _ = scene
    jp, tp = _covs(pts)
    ours = analysis.scene_lambdas(tp, tcams, W, H)
    ref = janalysis.scene_lambdas(jp, jax.tree.map(jnp.asarray, cams), W, H)
    assert set(ours) == set(ref) == {str(j) for j in range(N_J)}
    np.testing.assert_allclose(np.asarray([ours[k] for k in sorted(ours)]),
                               np.asarray([ref[k] for k in sorted(ref)]),
                               rtol=1e-6)
    aniso = analysis.anisotropy_per_joint(ours)
    assert aniso == janalysis.anisotropy_per_joint(ours)
    assert all(a >= 1.0 for views in aniso.values() for a in views)


def test_analyze_confidence_matches_jax(ply_tree, tmp_path):
    """build_info over the run (scene 3 read from its stop iteration) and
    analyze's statistics and plots, against the JAX tool."""
    run, loader, jloader, _ = ply_tree
    info = analyze_confidence.build_info(run, loader)
    ref = jconf.build_info(run, jloader)
    assert [s["scene"] for s in info] == [s["scene"] for s in ref]
    assert len(info) == 4
    for a, b in zip(info, ref):
        for joint in b["info"]:
            for k, v in b["info"][joint].items():
                _assert_within_scale(a["info"][joint][k], v,
                                     err_msg=f"{joint} {k}")
    res = analyze_confidence.analyze(info, out_dir=str(tmp_path / "plots"),
                                     n_joints=N_J, print_fn=lambda *a: None)
    jres = jconf.analyze(ref, n_joints=N_J, print_fn=lambda *a: None)
    assert res["coverage"] == jres["coverage"]
    assert res["coverage_per_joint"] == jres["coverage_per_joint"]
    np.testing.assert_allclose(res["corr_error_trace"],
                               jres["corr_error_trace"], rtol=1e-6)
    for png in res["plots"]:
        assert (tmp_path / "plots" / png).stat().st_size > 0


def test_analyze_confidence_cli(ply_tree, tmp_path, capsys):
    run, _, _, root = ply_tree
    analyze_confidence.main([run, "--data-root", root,
                             "--initial-guess", "metrabs", "--poses-2d",
                             "metrabs", "--end-id", "4",
                             "--out", str(tmp_path)])
    with open(tmp_path / "info_confidences.json") as f:
        assert len(json.load(f)) == 4
    assert "Percent inside sigmas" in capsys.readouterr().out


def _viewer_message(cam):
    """The viewer's wire format: transposed matrices with the column sign
    flips that ``receive`` undoes."""
    wvt = np.asarray(cam.view4, np.float32).T.copy()
    wvt[:, 1] *= -1
    wvt[:, 2] *= -1
    fpt = np.asarray(cam.full4, np.float32).T.copy()
    fpt[:, 1] *= -1
    return {"resolution_x": int(cam.width), "resolution_y": int(cam.height),
            "train": True, "fov_x": 2 * math.atan(float(cam.tan_fovx)),
            "fov_y": 2 * math.atan(float(cam.tan_fovy)),
            "z_near": 0.01, "z_far": 100.0, "shs_python": False,
            "rot_scale_python": True, "keep_alive": True,
            "scaling_modifier": 1.0,
            "view_matrix": [float(v) for v in wvt.reshape(-1)],
            "view_projection_matrix": [float(v) for v in fpt.reshape(-1)]}


def test_minicam_to_camera_matches_jax(scene):
    cam = take_cam(scene[0], 1)
    msg = _viewer_message(cam)
    args = (msg["resolution_x"], msg["resolution_y"], msg["fov_y"],
            msg["fov_x"], 0.01, 100.0,
            np.asarray(cam.view4, np.float32).T,
            np.asarray(cam.full4, np.float32).T)
    ours = network_gui.MiniCam(*args).to_camera(device="cpu")
    ref = jgui.MiniCam(*args).to_camera()
    for f in CAM_FIELDS:
        np.testing.assert_allclose(getattr(ours, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_network_gui_loopback_roundtrip(scene):
    """init/try_connect on 127.0.0.1, a camera message decoded into the
    port's Camera, and the image + verify reply framing."""
    cam = take_cam(scene[0], 0)
    assert network_gui.listener is None     # no socket on import
    network_gui.init("127.0.0.1", 0)
    port = network_gui.listener.getsockname()[1]
    client = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        for _ in range(200):
            network_gui.try_connect()
            if network_gui.conn is not None:
                break
            time.sleep(0.01)
        assert network_gui.conn is not None
        payload = json.dumps(_viewer_message(cam)).encode("utf-8")
        client.sendall(struct.pack("<I", len(payload)) + payload)
        mini, training, shs, rot_scale, keep_alive, scaling = \
            network_gui.receive()
        assert training and keep_alive and rot_scale and not shs
        assert scaling == 1.0
        decoded = mini.to_camera(device="cpu")
        np.testing.assert_allclose(decoded.view4.numpy(),
                                   np.asarray(cam.view4), atol=3e-5)
        np.testing.assert_allclose(decoded.full4.numpy(),
                                   np.asarray(cam.full4), atol=3e-5)
        np.testing.assert_allclose(float(decoded.focal_x),
                                   float(cam.focal_x), rtol=1e-5)
        image = bytes(range(12))
        network_gui.send(image, "verify-me")
        want = len(image) + 4 + len("verify-me")
        got = b""
        while len(got) < want:
            got += client.recv(want - len(got))
        assert got[:12] == image
        assert struct.unpack("<I", got[12:16])[0] == len("verify-me")
        assert got[16:] == b"verify-me"
    finally:
        client.close()
        network_gui.conn.close()
        network_gui.listener.close()
        network_gui.conn = network_gui.listener = None


def test_arguments_parse_like_jax(tmp_path, monkeypatch):
    argv = ["-s", "/data/scene", "--iterations", "700", "--eval",
            "--antialiasing", "--lambda_dssim", "0.5"]
    groups = {}
    for mod in (arguments, jarguments):
        parser = argparse.ArgumentParser()
        lp, op, pp = (mod.ModelParams(parser), mod.OptimizationParams(parser),
                      mod.PipelineParams(parser))
        args = parser.parse_args(argv)
        groups[mod] = [vars(g.extract(args)) for g in (lp, op, pp)]
    ours, ref = groups[arguments], groups[jarguments]
    assert ours[1:] == ref[1:]
    assert {**ours[0], "data_device": None} == {**ref[0], "data_device": None}
    assert ours[0]["data_device"] == "cuda"
    assert ours[0]["source_path"] == "/data/scene" and ours[1]["iterations"] == 700

    (tmp_path / "cfg_args").write_text(
        "Namespace(sh_degree=2, source_path='/saved', eval=True)")
    parser = argparse.ArgumentParser()
    arguments.ModelParams(parser, sentinel=True)
    monkeypatch.setattr(sys, "argv", ["render", "-m", str(tmp_path),
                                      "--sh_degree", "1"])
    merged = arguments.get_combined_args(parser)
    assert merged.sh_degree == 1 and merged.source_path == "/saved"
    with pytest.raises(ValueError):
        arguments.parse_namespace_repr("__import__('os')")


def test_ab_harness_matches_jax(tmp_path):
    gt_dir = tmp_path / "3d_gt" / "S9" / "Walking"
    os.makedirs(gt_dir)
    rng = np.random.default_rng(0)
    gt = rng.normal(0, 200, (3 * 64, N_J, 3)).astype(np.float32)
    np.savez(gt_dir / "poses.npz", poses=gt)
    for run, noise in (("ours", 5.0), ("theirs", 6.0)):
        d = tmp_path / run / "point_cloud" / "iteration_500"
        for f in range(3):
            ply.write_gaussian_ply(
                str(d / f"S9_Walking_{f * 64:06d}.ply"),
                (gt[f * 64] + rng.normal(0, noise, (N_J, 3))).astype(
                    np.float32), np.zeros((N_J, 3), np.float32),
                np.tile([1, 0, 0, 0], (N_J, 1)).astype(np.float32),
                np.zeros((N_J, 1), np.float32))
    args = (str(tmp_path / "ours"), str(tmp_path / "theirs"),
            str(tmp_path / "3d_gt"), 500)
    ours = ab_harness.compare(*args, print_fn=lambda *a: None)
    assert ours == jab.compare(*args, print_fn=lambda *a: None)
    assert ours["summary"]["n_scenes"] == 3
    assert 5 < ours["summary"]["mpjpe"]["ours_mean"] < 20


def test_parity_study_matches_jax(tmp_path):
    """One 192×160 scene, 12 iterations: the port's three renderers agree
    to 1e-3 mm, and its kernel renderer's tree agrees with the JAX tool's
    fused one (compared by the port's ab_harness)."""
    from skelsplat_tpu.tools import parity_study as jparity

    common = ["--scenes", "1", "--width", "192", "--height", "160",
              "--iterations", "12"]
    report = parity_study.main(common + ["--device", "cpu", "--out",
                                         str(tmp_path / "port")])
    assert set(report["pairs"]) == {"dense_vs_fused", "dense_vs_cuda",
                                    "fused_vs_cuda"}
    for row in report["pairs"].values():
        assert row["max_disagreement_mm"] <= 1e-3
    mpjpe = report["renderers"]["cuda"]["mpjpe_mm"][0]
    assert mpjpe < 60.0     # the initial guess is 67.8 mm off
    jparity.main(common + ["--renderers", "fused", "--out",
                           str(tmp_path / "jax")])
    out = ab_harness.compare(str(tmp_path / "port" / "cuda"),
                             str(tmp_path / "jax" / "fused"),
                             str(tmp_path / "port" / "3d_gt"), 12,
                             print_fn=lambda *a: None)
    assert out["summary"]["pose_disagreement_mm"]["max"] <= 1e-3


def test_viz_writes_pngs(tmp_path):
    pytest.importorskip("matplotlib", reason="viz needs matplotlib")
    rng = np.random.default_rng(1)
    pose = torch.as_tensor(rng.normal(0, 300, (N_J, 3)).astype(np.float32))
    hm = rng.random((N_J, 20, 24)).astype(np.float32)
    paths = [
        viz.show_joints_htmp(hm, str(tmp_path / "joints.png")),
        viz.show_single_htmp(hm[0], str(tmp_path / "single.png")),
        viz.save_rendering(torch.as_tensor(hm), hm, str(tmp_path / "r"),
                           "view0", 12),
        viz.plot_2d_pose(pose[:, :2], pose[:, :2] + 5,
                         out_path=str(tmp_path / "p2d.png")),
        viz.plot_3d_pose(pose, pose + 10, out_path=str(tmp_path / "p3d.png")),
        viz.plot_3d_gaussians(pose, torch.full((N_J, 3), 30.0),
                              out_path=str(tmp_path / "g3d.png")),
        viz.plot_gaussian_cloud(np.stack([pose.numpy(), pose.numpy() + 50]),
                                out_path=str(tmp_path / "cloud.png")),
        viz.plot_3d_pose_grounded(pose, out_path=str(tmp_path / "gr.png"),
                                  skeleton=viz.H36M_SKELETON),
    ]
    for p in paths:
        assert os.path.getsize(p) > 0
