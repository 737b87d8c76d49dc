"""The port's dense renderer, streaming loss and kernel module against the
JAX package on the same inputs (CPU; the kernel module runs its plain
PyTorch version here, the JAX kernel runs in Pallas interpret mode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skelsplat_tpu.engine.trainer import init_params_jnp
from skelsplat_tpu.ops import fused, heatmaps, rasterizer
from skelsplat_tpu.ops.pallas_raster import fused_view_loss_pallas
from skelsplat_tpu_torch import compat
from skelsplat_tpu_torch.ops import _build, cuda_raster
from skelsplat_tpu_torch.ops import fused as tfused
from skelsplat_tpu_torch.ops import heatmaps as thm
from skelsplat_tpu_torch.ops import rasterizer as trast
from tests.utils import project_np, synthetic_rig, synthetic_skeleton, take_cam

N_J = 17
W, H = 112, 96
NV = 3
FIELDS = ("xyz", "log_scales", "quats", "opacity_logit")


def _np_params(p):
    return {f: np.asarray(getattr(p, f)) for f in FIELDS}


def _torch_params(p, requires_grad=False):
    tp = compat.params_from_numpy(_np_params(p), device="cpu")
    if requires_grad:
        tp = tp.map(lambda x: x.requires_grad_(True))
    return tp


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
def scene():
    cams, _, _ = synthetic_rig(n_views=NV, width=W, height=H)
    rng = np.random.default_rng(3)
    gt = synthetic_skeleton(N_J, rng=rng, spread=300.0)
    p2d = np.stack([project_np(gt, take_cam(cams, v))
                    for v in range(NV)]).astype(np.float32)
    init = gt + rng.normal(0, 50, gt.shape).astype(np.float32)
    params = init_params_jnp(jnp.asarray(init), "h36m", 3.0, 1.0)
    # away from the symmetric init: anisotropic scales, real rotations
    r2 = np.random.default_rng(9)
    params2 = dataclasses.replace(
        params,
        log_scales=params.log_scales + jnp.asarray(
            r2.normal(0, 0.3, (N_J, 3)).astype(np.float32)),
        quats=params.quats + jnp.asarray(
            r2.normal(0, 0.2, (N_J, 4)).astype(np.float32)))
    spec = heatmaps.heatmap_spec(params.xyz, params.covariance(),
                                 jnp.asarray(p2d), cams, W, H)
    tcams = compat.camera_from_numpy(jax.tree.map(np.asarray, cams),
                                     device="cpu")
    tspec = compat.spec_from_numpy(jax.tree.map(np.asarray, spec),
                                   device="cpu")
    return dict(cams=cams, jcams=jax.tree.map(jnp.asarray, cams),
                params={"init": params, "posed": params2}, spec=spec,
                tcams=tcams, tspec=tspec)


def _assert_grads_close(g_ref, g_port, fields=FIELDS):
    """Gradients within 1e-5 of their scale (the JAX suite's bar between
    its own renderers)."""
    for nm in fields:
        a = np.asarray(getattr(g_ref, nm))
        b = getattr(g_port, nm).detach().numpy()
        scale = max(np.abs(a).max(), 1e-12)
        assert np.abs(a - b).max() < 1e-5 * max(scale, 1e-3), nm


def _port_grads(loss, tp):
    grads = torch.autograd.grad(loss, [getattr(tp, f) for f in FIELDS],
                                retain_graph=True)
    return type(tp)(*grads)


@pytest.mark.parametrize("which", ["init", "posed"])
def test_dense_render_and_grads_match_jax(scene, which):
    params = scene["params"][which]
    v = 1
    cam = take_cam(scene["jcams"], v)

    def jloss(p):
        return jnp.sum(rasterizer.render(p, cam, W, H)["render"] ** 2)

    # op by op, as the port evaluates: under jit XLA contracts a·b+c into
    # FMAs, which moves exp's argument by ~1e-5 at |power| ~ 10
    out = rasterizer.render(params, cam, W, H)
    tp = _torch_params(params, requires_grad=True)
    tout = trast.render(tp, scene["tcams"].take(v), W, H)
    np.testing.assert_allclose(tout["render"].detach().numpy(),
                               np.asarray(out["render"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tout["radii"].detach().numpy(),
                                  np.asarray(out["radii"]))
    np.testing.assert_allclose(tout["depth"].detach().numpy(),
                               np.asarray(out["depth"]), rtol=1e-5, atol=1e-9)
    g = jax.jit(jax.grad(jloss))(params)
    _assert_grads_close(g, _port_grads(torch.sum(tout["render"] ** 2), tp))


@pytest.mark.parametrize("loss_fn,aa", [("l2_gaussian", False),
                                        ("l1_gaussian", False),
                                        ("l2_gaussian", True)])
def test_fused_loss_and_grads_match_jax(scene, loss_fn, aa):
    params = scene["params"]["posed"]
    tp = _torch_params(params, requires_grad=True)
    tl = tfused.fused_view_loss(tp, scene["tcams"], scene["tspec"], W, H,
                                loss_function=loss_fn, antialiasing=aa)
    vg = jax.jit(jax.value_and_grad(lambda p, cam, sv: fused.fused_view_loss(
        p, cam, sv, W, H, loss_function=loss_fn, antialiasing=aa)))
    for v in range(NV):
        cam = take_cam(scene["jcams"], v)
        spec_v = jax.tree.map(lambda x: x[v], scene["spec"])
        ref, g = vg(params, cam, spec_v)
        assert abs(float(ref) - float(tl[v].detach())) < 1e-6, f"view {v}"
        _assert_grads_close(g, _port_grads(tl[v], tp))


@pytest.mark.parametrize("loss_fn", ["l2_gaussian", "l1_gaussian"])
def test_kernel_module_matches_pallas_interpret(scene, loss_fn):
    """fused_view_loss_cuda (plain K1 on the CPU) against the Pallas kernel
    in interpret mode: loss |Δ| < 1e-6, grads within 1e-5·scale."""
    params = scene["params"]["posed"]
    tp = _torch_params(params, requires_grad=True)
    prof = cuda_raster.view_profiles(scene["tspec"], W, H)
    tl = cuda_raster.fused_view_loss_cuda(tp, scene["tcams"], prof, W, H,
                                          loss_function=loss_fn)
    vg = jax.jit(jax.value_and_grad(
        lambda p, cam, sv: fused_view_loss_pallas(
            p, cam, sv, W, H, interpret=True, loss_function=loss_fn)))
    for v in range(NV):
        cam = take_cam(scene["jcams"], v)
        spec_v = jax.tree.map(lambda x: x[v], scene["spec"])
        ref, g = vg(params, cam, spec_v)
        assert abs(float(ref) - float(tl[v].detach())) < 1e-6, f"view {v}"
        _assert_grads_close(
            g, _port_grads(tl[v], tp), fields=("xyz", "log_scales", "quats"))


def _packed_inputs(scene, which="posed"):
    tp = _torch_params(scene["params"][which])
    prof = cuda_raster.view_profiles(scene["tspec"], W, H)
    pp = trast.preprocess_gaussians(tp.xyz, tp.covariance(), tp.opacity,
                                    scene["tcams"], W, H)
    gd, aux, p1s, p2s = cuda_raster.slot_pack(pp, prof)
    return torch.cat([gd, aux], dim=-1).contiguous(), p1s, p2s, prof.img


@pytest.mark.parametrize("l1", [False, True])
def test_plain_k2_equals_plain_k1_pass1(scene, l1):
    pack, p1s, p2s, img = _packed_inputs(scene)
    S1, C1, dg = cuda_raster.raster_loss_grad(pack, p1s, p2s, img, l1)
    S2, C2 = cuda_raster.raster_loss(pack, p1s, p2s, img, l1)
    assert torch.equal(S1, S2) and torch.equal(C1, C2)
    assert C1.dtype == torch.int32 and (C1 > 0).all()
    assert dg.shape == (NV, N_J, cuda_raster.N_GRAD)
    assert torch.isfinite(dg).all() and (dg != 0).any()


def test_plain_kernel_counts_no_launch_on_cpu(scene):
    pack, p1s, p2s, img = _packed_inputs(scene)
    before = _build.launch_counts()
    cuda_raster.raster_loss_grad(pack, p1s, p2s, img, False)
    assert _build.launch_counts(since=before) == dict.fromkeys(
        _build.KERNELS, 0)


def test_kernel_wrapper_rejects_bad_inputs(scene):
    pack, p1s, p2s, img = _packed_inputs(scene)
    with pytest.raises(TypeError):
        cuda_raster.raster_loss_grad(pack.double(), p1s, p2s, img, False)
    with pytest.raises(ValueError):
        cuda_raster.raster_loss_grad(pack[:, :, :8].contiguous(), p1s, p2s,
                                     img, False)
    with pytest.raises(ValueError):
        cuda_raster.raster_loss_grad(pack, p1s.transpose(1, 2), p2s, img,
                                     False)


def test_behind_camera_splat_is_culled(scene):
    """A splat behind every camera gets zero opacity in the pack, renders
    nothing and keeps the loss finite."""
    params = scene["params"]["posed"]
    d = _np_params(params)
    d["xyz"] = d["xyz"].copy()
    d["xyz"][4, 2] += 1e7
    tp = compat.params_from_numpy(d, device="cpu").map(
        lambda x: x.requires_grad_(True))
    prof = cuda_raster.view_profiles(scene["tspec"], W, H)
    tl = cuda_raster.fused_view_loss_cuda(tp, scene["tcams"], prof, W, H)
    ref = tfused.fused_view_loss(tp, scene["tcams"], scene["tspec"], W, H)
    np.testing.assert_allclose(tl.detach().numpy(), ref.detach().numpy(),
                               rtol=0, atol=1e-6)
    g = _port_grads(tl.sum(), tp)
    assert torch.isfinite(g.xyz).all()
    assert float(g.xyz[4].abs().max()) == 0.0
