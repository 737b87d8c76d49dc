"""The port's eval extras against the JAX package's, on the CPU: PSNR/MSE,
SSIM (plain, fused, the fused ``autograd.Function``'s gradient at both
paddings), LPIPS on its three backbones and its npz schema across the
packages, the native PLY codec against the numpy reader, and
``eval.image_metrics=true`` through the port's eval CLI against the root
``eval.py``.

Bars: SSIM values within 1e-6 (the two packages' convolutions sum in
different orders); SSIM gradients within 1e-5 of their scale; LPIPS
within rtol 2e-4 (the JAX package's own bar against a torch oracle); the
codec bitwise equal to the numpy reader."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import eval as jeval_cli
from skelsplat_tpu import evaluation as jevaluation
from skelsplat_tpu.ops import image_metrics as jim
from skelsplat_tpu.ops import lpips as jlpips
from skelsplat_tpu.ops import ssim as jssim
from skelsplat_tpu_torch import eval as teval_cli
from skelsplat_tpu_torch import evaluation as tevaluation
from skelsplat_tpu_torch import native
from skelsplat_tpu_torch.data import ply
from skelsplat_tpu_torch.data.loader import DataLoader
from skelsplat_tpu_torch.ops import image_metrics as tim
from skelsplat_tpu_torch.ops import lpips as tlpips
from skelsplat_tpu_torch.ops import ssim as tssim
from skelsplat_tpu_torch.tools import bench_ssim
from skelsplat_tpu_torch.tools import make_synthetic_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSIM_ATOL = 1e-6
GRAD_RTOL = 1e-5
LPIPS_RTOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run the port's CPU ops on one torch thread: under the test run's
    parallel workers, an intra-op thread per core in every worker contends
    for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def imgs():
    """A correlated (2,3,48,56) pair in [0, 1]."""
    rng = np.random.default_rng(0)
    a = rng.random((2, 3, 48, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.08, a.shape), 0, 1).astype(np.float32)
    return a, b


_PRECISION = """
import sys
import torch
import skelsplat_tpu_torch.eval
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
assert torch.get_float32_matmul_precision() == "highest"
loaded = [m for m in ("skelsplat_tpu_torch.ops.cuda_raster",
                      "skelsplat_tpu_torch.engine.trainer") if m in sys.modules]
assert not loaded, loaded
print("full precision")
"""


def test_eval_entry_point_turns_tf32_off():
    """The eval path reaches neither the kernel wrapper nor the trainer,
    yet its convolutions must run in full f32: the package sets the
    precision when it is imported."""
    out = subprocess.run([sys.executable, "-c", _PRECISION], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "full precision" in out.stdout


def test_mse_and_psnr_match_jax(imgs):
    a, b = imgs
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(tim.mse(ta, tb).numpy(),
                               np.asarray(jim.mse(a, b)), rtol=1e-6)
    np.testing.assert_allclose(tim.psnr(ta, tb).numpy(),
                               np.asarray(jim.psnr(a, b)), rtol=1e-6)


def test_plain_ssim_matches_jax(imgs):
    a, b = imgs
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(tssim.ssim(ta, tb)) - float(jssim.ssim(a, b))) \
        <= SSIM_ATOL
    np.testing.assert_allclose(
        tssim.ssim(ta, tb, size_average=False).numpy(),
        np.asarray(jssim.ssim(a, b, size_average=False)), atol=SSIM_ATOL)
    # CHW input squeezes to one image
    assert abs(float(tssim.ssim(ta[0], tb[0]))
               - float(jssim.ssim(a[0], b[0]))) <= SSIM_ATOL


def _plain_map(x, y, padding):
    mu1, mu2, s11, s22, s12 = tssim._ssim_stats(x, y, padding)
    return (((2 * mu1 * mu2 + tssim.C1) * (2 * s12 + tssim.C2))
            / ((mu1 * mu1 + mu2 * mu2 + tssim.C1) * (s11 + s22 + tssim.C2)))


@pytest.mark.parametrize("padding", ["same", "valid"])
def test_fused_ssim_and_its_gradient_match_jax(imgs, padding):
    a, b = imgs
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    jv = float(jssim.fused_ssim(a, b, padding))
    assert abs(float(tssim.fused_ssim(ta, tb, padding)) - jv) <= SSIM_ATOL
    assert abs(float(tssim.fused_ssim(ta[1], tb[1], padding))
               - float(jssim.fused_ssim(a[1], b[1], padding))) <= SSIM_ATOL
    if padding == "same":
        assert abs(float(tssim.fast_ssim(ta, tb)) - jv) <= SSIM_ATOL

    x = ta.clone().requires_grad_(True)
    y = tb.clone().requires_grad_(True)
    tssim.fused_ssim(x, y, padding).backward()
    g_jax = np.asarray(jax.grad(
        lambda u: jssim.fused_ssim(u, b, padding))(a))
    scale = np.abs(g_jax).max()
    assert np.abs(x.grad.numpy() - g_jax).max() <= GRAD_RTOL * scale
    # the reference image gets zeros, as JAX's custom VJP gives it
    assert torch.equal(y.grad, torch.zeros_like(y))
    # the cached-partials backward against autograd through the plain map
    # (with "valid", the zero-padded cotangent is what this checks)
    x2 = ta.clone().requires_grad_(True)
    _plain_map(x2, tb, padding).mean().backward()
    assert (x2.grad - x.grad).abs().max() <= GRAD_RTOL * scale


def test_bench_ssim_checks_the_gradient_on_the_cpu(capsys):
    out = bench_ssim.main(["--shape", "1", "2", "40", "36", "--device",
                           "cpu"])
    assert out["grad_max_abs_err"] <= bench_ssim.GRAD_ATOL
    assert abs(out["plain"] - out["fused"]) <= SSIM_ATOL
    assert "not measured" in capsys.readouterr().out
    assert "fused_ms" not in out


def _lpips_inputs():
    rng = np.random.default_rng(1)
    # alex needs >= 64 px for its stride-4 k11 conv chain
    return (rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32),
            rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32))


@pytest.mark.parametrize("net_type", ["vgg", "alex", "squeeze"])
def test_lpips_matches_jax(net_type):
    x, y = _lpips_inputs()
    w = tlpips.random_weights(net_type, seed=3)
    wj = jlpips.random_weights(net_type, seed=3)
    for key in ("conv_w", "conv_b", "lin_w"):
        assert len(w[key]) == len(wj[key])
        assert all(np.array_equal(p, q) for p, q in zip(w[key], wj[key]))
    model = tlpips.LPIPS.from_numpy(w, net_type, device="cpu")
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        feats = model._features(torch.from_numpy(x))
    jmodel = jlpips.LPIPS(wj, net_type)
    ref = np.asarray(jax.jit(lambda u, v: jmodel(u, v))(x, y))
    np.testing.assert_allclose(ours, ref, rtol=LPIPS_RTOL, atol=1e-6)
    assert (ours > 0).all()
    assert tuple(f.shape[1] for f in feats) == \
        tlpips.BACKBONES[net_type]["n_channels"]


def test_lpips_npz_loads_in_both_packages(tmp_path):
    """An npz in the JAX schema, written by hand as the JAX package's
    tests do, loads in the port; one the port writes loads in JAX."""
    x, y = _lpips_inputs()
    w = jlpips.random_weights("alex", seed=5)
    jax_file = str(tmp_path / "jax_alex.npz")
    out = {"net_type": np.asarray("alex")}
    for i, (cw, cb) in enumerate(zip(w["conv_w"], w["conv_b"])):
        out[f"conv{i}_w"], out[f"conv{i}_b"] = cw, cb
    for i, lw in enumerate(w["lin_w"]):
        out[f"lin{i}_w"] = lw
    np.savez(jax_file, **out)
    port_file = str(tmp_path / "port_alex.npz")
    tlpips.save_npz(port_file, tlpips.random_weights("alex", seed=5), "alex")

    jmodel = jlpips.LPIPS.from_npz(port_file)
    ref = np.asarray(jax.jit(lambda u, v: jmodel(u, v))(x, y))
    for path in (jax_file, port_file):
        model = tlpips.LPIPS.from_npz(path, device="cpu")
        assert model.net_type == "alex"
        with torch.no_grad():
            d = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
            same = model(torch.from_numpy(x), torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(d, ref, rtol=LPIPS_RTOL, atol=1e-6)
        np.testing.assert_allclose(same, 0.0, atol=1e-7)
        d2 = tlpips.lpips(torch.from_numpy(x), torch.from_numpy(y),
                          "alex", weights_path=path).detach().numpy()
        np.testing.assert_array_equal(d2, d)


def test_lpips_without_weights_raises_as_jax_does():
    z = np.zeros((1, 3, 8, 8), np.float32)
    assert tlpips.default_weights_path("vgg") is None
    with pytest.raises(RuntimeError, match="weights"):
        jlpips.lpips(z, z)
    with pytest.raises(RuntimeError, match="weights"):
        tlpips.lpips(torch.from_numpy(z), torch.from_numpy(z))


def _write_cloud(path, xyz):
    n = xyz.shape[0]
    ply.write_gaussian_ply(path, xyz, np.full((n, 3), 3.0, np.float32),
                           np.tile([1, 0, 0, 0], (n, 1)).astype(np.float32),
                           np.full((n, 1), 40.0, np.float32))


def test_codec_reads_what_the_numpy_reader_reads(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.normal(0, 100, (17, 3)).astype(np.float32)
    assert native.available()
    gauss, dbl, pts = (str(tmp_path / f) for f in ("g.ply", "d.ply", "p.ply"))
    _write_cloud(gauss, xyz)
    ply.write_xyz_double_ply(dbl, xyz.astype(np.float64) + 1e-3)
    ply.write_point_ply(pts, xyz, np.ones_like(xyz) * 255)
    for p in (gauss, dbl, pts):
        # the codec returns float32, rounding a double cloud to nearest
        got = native.read_xyz(p)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got,
                                      ply.read_xyz(p).astype(np.float32))

    paths = []
    for i in range(23):
        p = str(tmp_path / f"s{i}.ply")
        _write_cloud(p, rng.normal(0, 1000, (17, 3)).astype(np.float32))
        paths.append(p)
    out, counts = native.read_xyz_batch(paths, max_pts=64)
    assert out.shape == (23, 64, 3) and (counts == 17).all()
    ref = np.array([ply.read_xyz(p) for p in paths])
    np.testing.assert_array_equal(out[:, :17], ref)
    assert not out[:, 17:].any()
    np.testing.assert_array_equal(tevaluation._bulk_read(paths), ref)

    # a cloud above max_pts parses as an error code
    big = str(tmp_path / "big.ply")
    _write_cloud(big, rng.normal(0, 1, (70, 3)).astype(np.float32))
    _, counts = native.read_xyz_batch(paths[:2] + [big], max_pts=64)
    assert counts[0] == counts[1] == 17 and counts[2] < 0


def test_bulk_read_falls_back_where_jax_does(tmp_path):
    """A file the codec does not parse, or clouds of mixed sizes: the
    numpy reader, file by file, as the JAX eval does."""
    rng = np.random.default_rng(1)
    paths = [str(tmp_path / f"c{i}.ply") for i in range(3)]
    for p in paths:
        _write_cloud(p, rng.normal(0, 100, (15, 3)).astype(np.float32))
    # two spaces in the format line: the numpy reader splits on any
    # whitespace, the codec matches the line as written
    odd = str(tmp_path / "odd.ply")
    _write_cloud(odd, rng.normal(0, 100, (15, 3)).astype(np.float32))
    with open(odd, "rb") as f:
        data = f.read().replace(b"format binary_little_endian",
                                b"format  binary_little_endian", 1)
    with open(odd, "wb") as f:
        f.write(data)
    _, counts = native.read_xyz_batch(paths + [odd])
    assert (counts[:3] == 15).all() and counts[3] < 0
    np.testing.assert_array_equal(native.read_xyz(odd), ply.read_xyz(odd))
    mixed = str(tmp_path / "m.ply")
    _write_cloud(mixed, rng.normal(0, 100, (16, 3)).astype(np.float32))
    for group in (paths + [odd], paths):
        np.testing.assert_array_equal(
            tevaluation._bulk_read(group),
            np.array([ply.read_xyz(p) for p in group]))
    with pytest.raises(ValueError):   # ragged: as in the JAX eval
        tevaluation._bulk_read(paths + [mixed])
    # every cloud above the codec's 64 points: each count is the same
    # error code, which must not be taken for a size
    big = [str(tmp_path / f"big{i}.ply") for i in range(2)]
    for p in big:
        _write_cloud(p, rng.normal(0, 100, (70, 3)).astype(np.float32))
    assert (native.read_xyz_batch(big)[1] < 0).all()
    np.testing.assert_array_equal(tevaluation._bulk_read(big),
                                  np.array([ply.read_xyz(p) for p in big]))


def test_failed_codec_build_raises_with_the_compiler_output(tmp_path,
                                                            monkeypatch):
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'fake compiler: no such luck' >&2\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    with pytest.raises(RuntimeError, match="no such luck"):
        native.build()
    assert not list((tmp_path / "native").glob("*.so"))


# ---------------------------------------------------------------------------
# eval.image_metrics=true through both CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A 96 px synthetic H36M tree and a run dir of result clouds: scene 0
    under iteration_12 and iteration_24 (24 is its final cloud), scene 1
    under iteration_12 only (an early-stopped scene's layout)."""
    base = tmp_path_factory.mktemp("imgm")
    root = str(base / "synth-h36m")
    assert make_synthetic_dataset.write_tree(root, ["S9", "S11"], 64, 64,
                                             image_size=96) == 4
    loader = DataLoader(root, os.path.join(root, "initial_guess", "metrabs"),
                        os.path.join(root, "2d_metrabs"), end_id=2)
    run_dir = base / "run"
    rng = np.random.default_rng(7)
    for k, (_, rec) in enumerate(loader):
        n = rec.pose_3d.shape[0]
        for it in ((12, 24) if k == 0 else (12,)):
            xyz = (rec.pose_3d_gt if it == 24 else rec.pose_3d).astype(
                np.float32) + rng.normal(0, 5, (n, 3)).astype(np.float32)
            q = np.tile([1, 0, 0, 0], (n, 1)) + rng.normal(0, 0.2, (n, 4))
            ply.write_gaussian_ply(
                str(run_dir / "point_cloud" / f"iteration_{it}"
                    / f"{rec.scene_name}.ply"),
                xyz, 3.0 + rng.normal(0, 0.3, (n, 3)), q,
                np.full((n, 1), 40.0))
    weights = str(base / "squeeze.npz")
    tlpips.save_npz(weights, tlpips.random_weights("squeeze", seed=3),
                    "squeeze")
    return root, str(run_dir), weights


def test_scene_plys_match_the_jax_tool(run):
    from skelsplat_tpu.tools.analyze_confidence import _scene_plys

    _, run_dir, _ = run
    got = tevaluation._scene_plys(run_dir)
    assert got == _scene_plys(run_dir)
    assert [os.path.basename(os.path.dirname(p)) for p in got.values()] == \
        ["iteration_24", "iteration_12"]


def test_image_metrics_cli_matches_the_jax_cli(run, monkeypatch, capsys):
    root, run_dir, weights = run
    args = ["--config-name", "h36m.yaml", f"dataset.data_root={root}",
            "dataset.end_scene_id=2", "debug.save_iterations=[12]",
            f"eval.output_path={run_dir}", "eval.image_metrics=true",
            "eval.lpips_net=squeeze", f"eval.lpips_weights={weights}"]
    got = teval_cli.main(["--device", "cpu", *args])
    port_out = capsys.readouterr().out

    captured = []

    def keep(*a, **kw):
        captured.append(real(*a, **kw))
        return captured[-1]

    real = jevaluation.image_metrics
    monkeypatch.setattr(jevaluation, "image_metrics", keep)
    jeval_cli.main(args)
    jax_out = capsys.readouterr().out
    ref = captured[0]

    ours = got["image_metrics"]
    assert sorted(ours["per_scene"]) == sorted(ref["per_scene"])
    assert len(ours["per_scene"]) == 2
    for name, r in ref["per_scene"].items():
        o = ours["per_scene"][name]
        assert abs(o["ssim"] - r["ssim"]) <= SSIM_ATOL, name
        np.testing.assert_allclose(o["lpips"], r["lpips"], rtol=LPIPS_RTOL)
    assert abs(ours["ssim"] - ref["ssim"]) <= SSIM_ATOL
    np.testing.assert_allclose(ours["lpips"], ref["lpips"], rtol=LPIPS_RTOL)
    assert 0.0 < ours["ssim"] < 1.0 and ours["lpips"] > 0.0
    # the MPJPE report is unchanged beside it
    assert got[12]["absolute"] == pytest.approx(
        jevaluation.evaluate(os.path.join(root, "3d_gt"), run_dir, [12], 0,
                             2, print_fn=lambda *_: None)[12]["absolute"],
        abs=1e-9)
    for line in ("SSIM (render vs GT heatmaps)", "LPIPS (squeeze)"):
        assert line in port_out and line in jax_out

    # without weights: SSIM only, as JAX
    got = teval_cli.main(["--device", "cpu", *args[:-2]])
    assert got["image_metrics"]["lpips"] is None
    assert abs(got["image_metrics"]["ssim"] - ref["ssim"]) <= SSIM_ATOL
    assert "reporting SSIM only" in capsys.readouterr().out
