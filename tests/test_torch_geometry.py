"""The port's core math (geometry, cameras, Gaussian parameters) against the
JAX package, function by function, on random cameras and parameters; and
the port's isolation from JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skelsplat_tpu.core import cameras as jcameras
from skelsplat_tpu.core import gaussians as jgaussians
from skelsplat_tpu.core import geometry as jg
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.core import cameras as tcameras
from skelsplat_tpu_torch.core import gaussians as tgaussians
from skelsplat_tpu_torch.core import geometry as tg

N = 19
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_camera(rng, width=1002, height=1000):
    th = rng.uniform(0, 2 * np.pi)
    dist = rng.uniform(3000, 6000)
    pos = np.array([dist * np.cos(th), dist * np.sin(th), rng.uniform(500, 1500)])
    z = np.array([0, 0, 900.0]) + rng.normal(0, 100, 3) - pos
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0.0, 0.0, -1.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    f = rng.uniform(0.9, 1.3) * width
    K = np.array([[f, 0, width / 2 + rng.uniform(-20, 20)],
                  [0, f * rng.uniform(0.98, 1.02), height / 2 + rng.uniform(-20, 20)],
                  [0, 0, 1.0]])
    return R.T, -R @ pos, K, width, height


@pytest.fixture(scope="module")
def rig():
    rng = np.random.default_rng(11)
    jc, tc = [], []
    for v in range(3):
        args = _random_camera(rng, width=(1000, 1002, 640)[v])
        jc.append(jcameras.make_camera(*args, uid=v))
        tc.append(tcameras.make_camera(*args, uid=v, device="cpu"))
    xyz = rng.normal(0, 300, (N, 3)).astype(np.float32)
    xyz[:, 2] += 900
    xyz[0, 2] += 1e5           # one joint far behind/outside the views
    log_scales = rng.normal(3.0, 0.5, (N, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (N, 4)).astype(np.float32)
    return jc, tc, xyz, log_scales, quats


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port, ref, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def test_constants_match():
    for name in ("BLOCK_X", "BLOCK_Y", "H_VAR", "NEAR_Z", "ALPHA_MAX",
                 "ALPHA_MIN", "T_MIN"):
        assert getattr(tg, name) == getattr(jg, name), name
    assert tgaussians.OPACITY_INIT_LOGIT == jgaussians.OPACITY_INIT_LOGIT == 40
    assert tgaussians.EXTREMITY_JOINTS == jgaussians.EXTREMITY_JOINTS
    assert tgaussians.N_JOINTS == jgaussians.N_JOINTS


def test_alpha_clamp_straight_through():
    x = np.array([0.5, 0.99, 1.0, 3.0, 1e-3], np.float32)
    jv, jgrad = jax.value_and_grad(lambda a: jnp.sum(jg.alpha_clamp(a) * 2.0))(x)
    tx = _t(x).requires_grad_(True)
    y = tg.alpha_clamp(tx)
    (y * 2.0).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.minimum(np.float32(0.99), x))
    assert y[2].item() == np.float32(0.99)
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(tx.grad.numpy(), np.full(5, 2.0, np.float32))


def test_opacity_logit_pins_opacity():
    logit = torch.full((3, 1), tgaussians.OPACITY_INIT_LOGIT, requires_grad=True)
    s = torch.sigmoid(logit)
    s.sum().backward()
    assert (s == 1.0).all() and (logit.grad == 0.0).all()


def test_host_camera_math_matches(rig):
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, 4)
    q /= np.linalg.norm(q)
    np.testing.assert_array_equal(tg.qvec2rotmat(q), jg.qvec2rotmat(q))
    R = jg.qvec2rotmat(q)
    np.testing.assert_array_equal(tg.rotmat2qvec(R), jg.rotmat2qvec(R))
    t = rng.normal(0, 1000, 3)
    np.testing.assert_array_equal(tg.world2view(R, t), jg.world2view(R, t))
    np.testing.assert_array_equal(tg.world2view(R, t, np.ones(3), 2.0),
                                  jg.world2view(R, t, np.ones(3), 2.0))
    K = np.array([[1100.0, 0, 505], [0, 1110, 495], [0, 0, 1]])
    np.testing.assert_array_equal(tg.projection_from_K(0.01, 100, K, 1002, 1000),
                                  jg.projection_from_K(0.01, 100, K, 1002, 1000))
    np.testing.assert_array_equal(tg.projection_symmetric(0.01, 100, 0.8, 0.7),
                                  jg.projection_symmetric(0.01, 100, 0.8, 0.7))
    assert tg.focal2fov(1100.0, 1002) == jg.focal2fov(1100.0, 1002)
    assert tg.fov2focal(0.8, 1002) == jg.fov2focal(0.8, 1002)


def test_cameras_match(rig):
    jc, tc, *_ = rig
    jb = jcameras.stack_cameras(jc)
    tb = tcameras.stack_cameras(tc)
    via_compat = compat.camera_from_numpy(jax.tree.map(np.asarray, jb),
                                          device="cpu")
    for f in tcameras.FIELDS:
        ref = np.asarray(getattr(jb, f))
        np.testing.assert_array_equal(getattr(tb, f).numpy(), ref, err_msg=f)
        np.testing.assert_array_equal(getattr(via_compat, f).numpy(), ref,
                                      err_msg=f)


def test_init_params_and_covariance_match(rig):
    *_, xyz, log_scales, quats = rig
    for modifier, scaling in ((1.25, 3.0), (1.0, 0.0)):
        jp = jgaussians.init_params(xyz, "panoptic", scaling, modifier)
        tp = tgaussians.init_params(xyz, "panoptic", scaling, modifier,
                                    device="cpu")
        for f in tgaussians.PARAM_FIELDS:
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)), err_msg=f)
    jp = jgaussians.GaussianParams(jnp.asarray(xyz), jnp.asarray(log_scales),
                                   jnp.asarray(quats), jnp.zeros((N, 1)))
    tp = compat.params_from_numpy(
        {"xyz": xyz, "log_scales": log_scales, "quats": quats,
         "opacity_logit": np.zeros((N, 1))}, device="cpu")
    _close(tp.covariance(), jp.covariance(), rtol=2e-6, atol=1e-3)
    _close(tp.covariance(1.3), jp.covariance(1.3), rtol=2e-6, atol=1e-3)
    _close(tg.quat_to_rotmat(_t(quats)), jg.quat_to_rotmat(quats), atol=1e-7)
    _close(tp.rotations, jp.rotations, atol=1e-7)


@pytest.mark.parametrize("v", [0, 1, 2])
def test_projection_and_ewa_match(rig, v):
    jc, tc, xyz, log_scales, quats = rig
    cov6 = np.asarray(jg.build_cov3d(np.exp(log_scales), quats))
    j, t = jc[v], tc[v].per_point()
    tx, tcov = _t(xyz), _t(cov6)
    _close(tg.view_transform_point(tx, t.view4),
           jg.view_transform_point(xyz, j.view4), rtol=1e-6, atol=1e-3)
    ndc_t = tg.project_point_full(tx, t.full4)
    ndc_j = jg.project_point_full(xyz, j.full4)
    _close(ndc_t, ndc_j, rtol=1e-6, atol=1e-7)
    _close(tg.ndc2pix(ndc_t[..., 0], t.width),
           jg.ndc2pix(ndc_j[..., 0], j.width), rtol=1e-6, atol=1e-4)
    args_j = (j.view4, j.focal_x, j.focal_y, j.tan_fovx, j.tan_fovy)
    args_t = (t.view4, t.focal_x, t.focal_y, t.tan_fovx, t.tan_fovy)
    render_t = tg.ewa_cov2d_render(tx, tcov, *args_t)
    render_j = jg.ewa_cov2d_render(xyz, cov6, *args_j)
    heat_t = tg.ewa_cov2d_heatmap(tx, tcov, *args_t)
    heat_j = jg.ewa_cov2d_heatmap(xyz, cov6, *args_j)
    scale = float(np.abs(np.asarray(render_j)).max())
    _close(render_t, render_j, rtol=1e-5, atol=1e-6 * scale)
    _close(heat_t, heat_j, rtol=1e-5, atol=1e-6 * scale)
    # the conventions really differ: the port keeps both
    assert not np.allclose(np.asarray(render_j)[:, 1], np.asarray(heat_j)[:, 1])
    conic_t, radius_t, det_t = tg.cov2d_to_conic_radius(render_t)
    conic_j, radius_j, det_j = jg.cov2d_to_conic_radius(render_j)
    _close(conic_t, conic_j, rtol=1e-4, atol=1e-9)
    np.testing.assert_array_equal(radius_t.numpy(), np.asarray(radius_j))
    s1_t, s2_t = tg.heatmap_sigmas(heat_t)
    s1_j, s2_j = jg.heatmap_sigmas(heat_j)
    _close(s1_t, s1_j, rtol=1e-5)
    _close(s2_t, s2_j, rtol=1e-5)


def test_tile_rect_matches(rig):
    rng = np.random.default_rng(2)
    pix = rng.uniform(-300, 1300, (200, 2)).astype(np.float32)
    radius = np.ceil(rng.uniform(0, 200, 200)).astype(np.float32)
    for (W, H) in ((1002, 1000), (112, 96)):
        tmin, tmax = tg.tile_rect(_t(pix), _t(radius), W, H)
        jmin, jmax = jg.tile_rect(pix, radius, W, H)
        np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
        np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
        assert tmin.dtype == torch.int32


def test_expon_lr_matches():
    steps = np.array([0, 1, 4, 100, 499, 500, 3999, 4000, 5000], np.float32)
    for kw in ({}, {"lr_delay_steps": 50, "lr_delay_mult": 0.1}):
        ref = jg.expon_lr(steps, 5e-4, 5e-6, max_steps=4000, **kw)
        out = tg.expon_lr(_t(steps), 5e-4, 5e-6, max_steps=4000, **kw)
        _close(out, ref, rtol=2e-6)
    assert (tg.expon_lr(_t(steps), 0.0, 0.0) == 0).all()


def test_geometry_grads_match(rig):
    """Autograd through the preprocess chain (view, projection, render-
    convention EWA, conic) against JAX autodiff."""
    jc, tc, xyz, log_scales, quats = rig
    j, t = jc[1], tc[1].per_point()

    def jf(x, ls, q):
        cov = jg.build_cov3d(jnp.exp(ls), q)
        c2 = jg.ewa_cov2d_render(x, cov, j.view4, j.focal_x, j.focal_y,
                                 j.tan_fovx, j.tan_fovy)
        conic, _, _ = jg.cov2d_to_conic_radius(c2)
        ndc = jg.project_point_full(x, j.full4)
        return jnp.sum(conic[1:] * 1e3) + jnp.sum(ndc[1:, :2])

    g_ref = jax.grad(jf, argnums=(0, 1, 2))(xyz, log_scales, quats)
    tx, tls, tq = (_t(a).requires_grad_(True) for a in (xyz, log_scales, quats))
    cov = tg.build_cov3d(torch.exp(tls), tq)
    c2 = tg.ewa_cov2d_render(tx, cov, t.view4, t.focal_x, t.focal_y,
                             t.tan_fovx, t.tan_fovy)
    conic, _, _ = tg.cov2d_to_conic_radius(c2)
    ndc = tg.project_point_full(tx, t.full4)
    (torch.sum(conic[1:] * 1e3) + torch.sum(ndc[1:, :2])).backward()
    for a, b in zip((tx.grad, tls.grad, tq.grad), g_ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() < 1e-5 * max(np.abs(b).max(), 1e-12)


_ISOLATION = """
import sys
import skelsplat_tpu_torch
import skelsplat_tpu_torch.compat, skelsplat_tpu_torch.synthetic
import skelsplat_tpu_torch.engine.trainer, skelsplat_tpu_torch.ops._build
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'skelsplat_tpu'))
assert not bad, bad
print('isolated')
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_default_device_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tgaussians.init_params(np.zeros((17, 3)), "h36m", 3.0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcameras.make_camera(*_random_camera(np.random.default_rng(0)))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SceneTrainer(tgaussians.SkeletonModel("h36m", 17), OptConfig(),
                     TrainSettings(), 1002, 1000)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        compat.params_from_numpy({f: np.zeros((17, 3)) for f in
                                  tgaussians.PARAM_FIELDS})
