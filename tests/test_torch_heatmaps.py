"""The port's closed-form GT heatmaps against the JAX package: spec fields
and evaluated heatmaps, on a mixed-width rig and with a dropout mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skelsplat_tpu.core.cameras import make_camera, stack_cameras
from skelsplat_tpu.core.gaussians import init_params
from skelsplat_tpu.ops import heatmaps
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.ops import cuda_raster
from skelsplat_tpu_torch.ops import heatmaps as thm
from tests.utils import project_np, synthetic_skeleton, take_cam

N_J = 17
INT_FIELDS = ("y0", "x0", "r1", "r2")


def _mixed_rig(widths, height):
    """A ring of cameras whose true widths differ (H36M mixes 1000- and
    1002-wide cameras); the evaluation grid is the widest."""
    cams = []
    for v, w in enumerate(widths):
        th = 2 * np.pi * v / len(widths) + 0.35
        pos = np.array([4000 * np.cos(th), 4000 * np.sin(th), 900.0])
        z = np.array([0.0, 0.0, 800.0]) - pos
        z /= np.linalg.norm(z)
        x = np.cross(np.array([0.0, 0.0, -1.0]), z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        f = 1.1 * w
        K = np.array([[f, 0, w / 2 + 3.0], [0, f * 1.01, height / 2 - 2.0],
                      [0, 0, 1.0]])
        cams.append(make_camera(R.T, -R @ pos, K, w, height, uid=v))
    return stack_cameras(cams)


@pytest.fixture(scope="module", params=["mixed", "dropout"])
def case(request):
    widths, H = (112, 110, 96), 96
    W = max(widths)
    cams = _mixed_rig(widths, H)
    rng = np.random.default_rng(4)
    pts = synthetic_skeleton(N_J, rng=rng, spread=300.0)
    p2d = np.stack([project_np(pts, take_cam(cams, v)) for v in range(3)])
    p2d = (p2d + rng.normal(0, 1.5, p2d.shape)).astype(np.float32)
    p2d[0, 2] = [-7.0, 500.0]          # off-image: clamped to the border
    drop = None
    if request.param == "dropout":
        drop = np.zeros((3, N_J), bool)
        drop[[0, 2], 5] = True
        drop[1, [3, 11]] = True
    params = init_params(pts, "h36m", scaling=3.0)
    cov6 = np.asarray(params.covariance())
    spec = heatmaps.heatmap_spec(params.xyz, cov6, jnp.asarray(p2d), cams,
                                 W, H, drop_mask=drop)
    tcams = compat.camera_from_numpy(jax.tree.map(np.asarray, cams),
                                     device="cpu")
    tspec = thm.heatmap_spec(torch.tensor(np.asarray(params.xyz)),
                             torch.tensor(cov6), torch.tensor(p2d), tcams,
                             W, H, drop_mask=drop)
    return spec, tspec, W, H, drop


def test_spec_fields_match(case):
    spec, tspec, W, H, drop = case
    for f in thm.HeatmapSpec._fields:
        ref = np.asarray(getattr(spec, f))
        port = getattr(tspec, f).numpy()
        if f in INT_FIELDS:
            assert port.dtype == np.int32, f
            np.testing.assert_array_equal(port, ref, err_msg=f)
        else:
            np.testing.assert_allclose(port, ref, rtol=2e-6, atol=0,
                                       err_msg=f)
    np.testing.assert_array_equal(tspec.width.numpy()[:, 0], [112, 110, 96])
    if drop is not None:
        assert (tspec.amp.numpy()[drop] == 0).all()


def test_eval_heatmaps_match(case):
    spec, tspec, W, H, drop = case
    ref = np.asarray(heatmaps.eval_heatmaps(spec, W, H))
    port = thm.eval_heatmaps(tspec, W, H).numpy()
    assert port.shape == ref.shape == (3, N_J, H, W)
    np.testing.assert_allclose(port, ref, rtol=0, atol=2e-6)
    # zero outside each view's true width
    assert (port[1, :, :, 110:] == 0).all() and (port[2, :, :, 96:] == 0).all()
    if drop is not None:
        assert (port[drop] <= 0).all()


def test_view_profiles_reproduce_eval_heatmaps(case):
    """The kernel's factored GT gt = p1'·p2 + B (with the nonzero spans
    bounding gt > 0) reproduces the evaluated heatmaps."""
    spec, tspec, W, H, drop = case
    prof = cuda_raster.view_profiles(tspec, W, H)
    gt = prof.p1[..., :, None] * prof.p2[..., None, :] + prof.B[..., None, None]
    ref = thm.eval_heatmaps(tspec, W, H)
    ys = torch.arange(H)[:, None]
    xs = torch.arange(W)
    inside = (ys < prof.img[:, 1, None, None, None]) & (xs < prof.img[:, 0, None, None, None])
    np.testing.assert_allclose(torch.where(inside, gt, 0.0).numpy(),
                               ref.numpy(), rtol=0, atol=2e-6)
    gy0, gy1, gx0, gx1 = (prof.spans[..., k, None, None] for k in range(4))
    in_span = (ys >= gy0) & (ys < gy1) & (xs >= gx0) & (xs < gx1)
    assert not ((gt > 0) & ~in_span).any()
