"""The "cuda" renderer's analytic step (``ops/cuda_preprocess.py``: the
forward, K1's plain version and the hand-written backward) against
autograd of the same loss (``cuda_raster.make_cuda_view_loss``) with one
parameter copy per view (``kernel_probe.autograd_step``; CPU).

Every gradient field is held to 1e-5 of its largest magnitude; the
losses are the same computation and equal bitwise. Imports neither JAX
nor the JAX package."""

import pytest
import torch

from skelsplat_tpu_torch.core.gaussians import PARAM_FIELDS
from skelsplat_tpu_torch.ops import cuda_preprocess, rasterizer
from skelsplat_tpu_torch.tools.kernel_probe import autograd_step, step_inputs

W, H = 96, 80
LAMBDA = 1e-2     # the limb prior's weight, 1,000× the configs' so it shows

# (scene type, antialiasing, loss, scenes, consistency, special inputs)
CASES = [(st, aa, loss, ns, cons, None)
         for st in ("h36m", "panoptic", "occlusion-person")
         for aa in (False, True)
         for loss in ("l2_gaussian", "l1_gaussian")
         for ns in (1, 3)
         for cons in ("3D_length_consistency", "none")]
CASES += [("h36m", aa, "l2_gaussian", 3, "3D_length_consistency", special)
          for special in ("behind_camera", "beyond_clamp", "infinite_logit")
          for aa in (False, True)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops on one torch thread (the tier-1 run's
    parallel workers would contend for the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) for x in c if x is not None))
def test_analytic_step_matches_autograd(case):
    scene_type, aa, loss, ns, cons, special = case
    params, cams, prof, A = step_inputs(
        scene_type, ns, W, H, device="cpu",
        **({special: True} if special else {}))
    ref_losses, ref = autograd_step(params, cams, prof, A, aa, loss,
                                    scene_type, cons, LAMBDA)
    fwd = cuda_preprocess.view_forward(params, cams, prof, A, aa, loss)
    losses, grads = cuda_preprocess.preprocess_grad(
        params, cams, *fwd, A, W, H, aa,
        cuda_preprocess.limb_pairs(cons, scene_type), LAMBDA)
    assert torch.equal(losses, ref_losses)
    for f in PARAM_FIELDS:
        got, want = getattr(grads, f), ref[f]
        assert got.shape == want.shape, f
        assert torch.isfinite(got).all(), f
        scale = want.abs().max()
        assert (got - want).abs().max() <= 1e-5 * scale, (f, scale)
    if special == "infinite_logit":
        assert torch.equal(grads.opacity_logit,
                           torch.zeros_like(grads.opacity_logit))

    # the backward's recomputed forward is the forward, bitwise
    pv = cuda_preprocess._per_view(params, A)
    pp = rasterizer.preprocess_gaussians(pv.xyz, pv.covariance(), pv.opacity,
                                         cams, W, H, aa)
    terms = cuda_preprocess._Terms(pv, cams, W, H, aa)
    assert torch.equal(terms.valid, pp.valid)
    assert torch.equal(torch.stack([terms.px, terms.py], dim=-1), pp.pix)
    assert torch.equal(torch.stack(terms.conic, dim=-1), pp.conic)
    assert torch.equal(terms.oe, pp.opacity_eff)
    if special == "behind_camera":
        assert not pp.valid[0, 4]
    if special == "beyond_clamp":
        assert (terms.u[0][1, 7] > terms.lim[0][1, 0]) and pp.valid[1, 7]
