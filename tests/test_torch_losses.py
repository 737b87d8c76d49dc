"""The port's loss registry against the JAX package's: every one of the
13 losses and ``softargmax2d`` on the same seeded batch of (A,C,H,W)
renderings, with and without a per-view ``domain`` (a padded rig of two
widths), value and gradient with respect to the rendering. JAX runs one
view at a time, as its trainer does under ``vmap``; the port takes the
batch at once and reduces per view.

Bars: a loss within rtol 1e-5 (the soft-argmax losses are in px²) and
atol 1e-6 (the heatmap losses' bar), a gradient within 1e-5 of its view's
largest |component|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skelsplat_tpu import losses as jlosses
from skelsplat_tpu_torch import losses as tlosses

A, C, H, W = 2, 5, 24, 30
WIDTHS = (30, 27)     # view 1 is padded from 27 to 30 columns
HEIGHTS = (24, 24)
LAMBDA = 0.05


@pytest.fixture(scope="module")
def batch():
    """Renderings and GT maps with exact zeros (the clip), zero on each
    view's pad, and 2D keypoints inside the image."""
    rng = np.random.default_rng(0)
    r = np.clip(rng.normal(0.2, 0.3, (A, C, H, W)), 0, 1).astype(np.float32)
    g = np.clip(rng.normal(0.1, 0.3, (A, C, H, W)), 0, 1).astype(np.float32)
    for v, w in enumerate(WIDTHS):
        r[v, :, :, w:] = 0
        g[v, :, :, w:] = 0
    p2d = rng.uniform(0, H, (A, C, 2)).astype(np.float32)
    return r, g, p2d


def _jax_view(fn, r, v, domain):
    """JAX's value and gradient of view ``v``'s loss ``fn(rendering)``."""
    dom = (np.float32(WIDTHS[v]), np.float32(HEIGHTS[v])) if domain else None
    val, grad = jax.value_and_grad(lambda x: fn(x, v, dom))(jnp.asarray(r[v]))
    return float(val), np.asarray(grad)


def _torch_batch(fn, r, domain):
    dom = ((torch.tensor(WIDTHS, dtype=torch.float32),
            torch.tensor(HEIGHTS, dtype=torch.float32)) if domain else None)
    rt = torch.tensor(r, requires_grad=True)
    val = fn(rt, dom)
    grad, = torch.autograd.grad(val.sum(), rt)
    return val.detach().numpy(), grad.numpy()


def _assert_grad_close(got, ref):
    for v in range(A):
        scale = np.abs(ref[v]).max()
        assert np.abs(got[v] - ref[v]).max() <= 1e-5 * max(scale, 1e-30), v


def test_registry_names_match_jax():
    assert list(tlosses.losses) == list(jlosses.losses)
    assert list(tlosses.consistency_losses) == list(jlosses.consistency_losses)
    assert list(tlosses.early_stopping_strategy) == \
        list(jlosses.early_stopping_strategy)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("domain", [False, True], ids=["full", "domain"])
@pytest.mark.parametrize("name", list(jlosses.losses))
def test_loss_matches_jax(batch, name, domain, reduction):
    r, g, p2d = batch

    def jfn(x, v, dom):
        return jlosses.losses[name](x, jnp.asarray(g[v]), jnp.asarray(p2d[v]),
                                    LAMBDA, reduction=reduction,
                                    domain=dom)[0]

    def tfn(x, dom):
        return tlosses.losses[name](x, torch.tensor(g), torch.tensor(p2d),
                                    LAMBDA, reduction=reduction,
                                    domain=dom)[0]

    ref = [_jax_view(jfn, r, v, domain) for v in range(A)]
    val, grad = _torch_batch(tfn, r, domain)
    assert val.shape == (A,)
    np.testing.assert_allclose(val, [v for v, _ in ref], rtol=1e-5,
                               atol=1e-6)
    _assert_grad_close(grad, np.stack([gr for _, gr in ref]))


def test_masked_losses_ignore_the_domain(batch):
    """The union-of-support mask is zero on the pad, so a domain changes
    nothing; the plain l1 mean divides by each view's true pixel count."""
    r, g, p2d = batch
    args = (torch.tensor(r), torch.tensor(g), torch.tensor(p2d), LAMBDA)
    dom = (torch.tensor(WIDTHS, dtype=torch.float32),
           torch.tensor(HEIGHTS, dtype=torch.float32))
    for name in ("l2_gaussian", "l1_gaussian", "l1_masked",
                 "l2_gaussian_l1_gaussian"):
        assert torch.equal(tlosses.losses[name](*args)[0],
                           tlosses.losses[name](*args, domain=dom)[0]), name
    full = tlosses.l1_loss(*args)[0]
    true = tlosses.l1_loss(*args, domain=dom)[0]
    assert float(full[0]) == pytest.approx(float(true[0]), rel=1e-6)
    assert float(true[1]) == pytest.approx(float(full[1]) * 30 / 27,
                                           rel=1e-6)


@pytest.mark.parametrize("domain", [False, True], ids=["full", "domain"])
def test_softargmax2d_matches_jax(batch, domain):
    r, _, _ = batch
    wts = np.random.default_rng(1).normal(0, 1, (C, 2)).astype(np.float32)

    def jfn(x, v, dom):
        return jnp.sum(jlosses.softargmax2d(x, domain=dom) * wts)

    ref = [_jax_view(jfn, r, v, domain) for v in range(A)]
    jpts = np.stack([np.asarray(jlosses.softargmax2d(
        jnp.asarray(r[v]),
        domain=(np.float32(WIDTHS[v]), np.float32(HEIGHTS[v]))
        if domain else None)) for v in range(A)])

    dom = ((torch.tensor(WIDTHS, dtype=torch.float32),
            torch.tensor(HEIGHTS, dtype=torch.float32)) if domain else None)
    pts = tlosses.softargmax2d(torch.tensor(r), domain=dom).numpy()
    assert pts.shape == (A, C, 2)
    np.testing.assert_allclose(pts, jpts, rtol=1e-5, atol=1e-5)
    if domain:   # no mass on view 1's pad columns
        assert (pts[1, :, 0] <= WIDTHS[1] - 1 + 1e-4).all()
    _, grad = _torch_batch(
        lambda x, d: torch.sum(tlosses.softargmax2d(x, domain=d)
                               * torch.tensor(wts), dim=(-2, -1)), r, domain)
    _assert_grad_close(grad, np.stack([gr for _, gr in ref]))
