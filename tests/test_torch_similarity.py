"""The port's ``ops/similarity.py`` and ``engine/early_stopping.py``
against the JAX package's: every similarity function on the same seeded
per-view gradient stacks (a joint whose gradient is zero in every view
among them), the port's leading scene axis against per-scene calls, and
the early-stopping classes on one loss sequence. Bars: similarities and
weights within 1e-6, fused gradients within 1e-6 of their scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skelsplat_tpu.engine import early_stopping as jstop
from skelsplat_tpu.ops import similarity as jsim
from skelsplat_tpu_torch.engine import early_stopping as tstop
from skelsplat_tpu_torch.ops import similarity as tsim

V, N, D, B = 4, 17, 3, 3
ZERO_JOINT = 5


@pytest.fixture(scope="module")
def grads():
    """(B,V,N,3) per-view gradient stacks of B scenes: spread directions
    and magnitudes, joint ZERO_JOINT zero in every view of every scene,
    and in scene 0 one view of joint 0 zero alone."""
    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, (B, V, N, D)) * rng.lognormal(0, 1, (B, V, N, 1))
    g[:, :, ZERO_JOINT] = 0
    g[0, 2, 0] = 0
    return g.astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, ref, tol=1e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("fn", ["pairwise_cosine_similarity",
                                "pairwise_cosine_norm_similarity",
                                "confidence_weighted_mean",
                                "view_consistency_scores"])
def test_gradient_functions_match_jax(grads, fn):
    ref = np.stack([np.asarray(getattr(jsim, fn)(jnp.asarray(g)))
                    for g in grads])
    got = getattr(tsim, fn)(_t(grads)).numpy()
    _close(got, ref)
    # the leading scene axis equals one call per scene
    per = np.stack([getattr(tsim, fn)(_t(g)).numpy() for g in grads])
    np.testing.assert_array_equal(got, per)


def test_zero_joint_fuses_to_zero(grads):
    fused = tsim.confidence_weighted_mean(_t(grads)).numpy()
    assert (fused[:, ZERO_JOINT] == 0).all()
    sim = tsim.pairwise_cosine_norm_similarity(_t(grads)).numpy()
    off = ~np.eye(V, dtype=bool)
    assert (sim[:, ZERO_JOINT][:, off] == 0).all()
    assert (np.diagonal(sim, axis1=-2, axis2=-1) == 1).all()


def test_all_zero_weights_fall_back_to_the_plain_mean(grads, monkeypatch):
    """A joint whose weights are all zero takes the plain mean over views,
    in both packages (the weights of joint 3 zeroed in both)."""
    def zero_joint_3(orig):
        def weights(sim, n_other=None):
            w = orig(sim, n_other)
            return w.at[..., 3].set(0) if hasattr(w, "at") else \
                w.index_fill(-1, torch.tensor([3]), 0.0)
        return weights

    monkeypatch.setattr(jsim, "compute_scaling_weights",
                        zero_joint_3(jsim.compute_scaling_weights))
    monkeypatch.setattr(tsim, "compute_scaling_weights",
                        zero_joint_3(tsim.compute_scaling_weights))
    ref = np.stack([np.asarray(jsim.confidence_weighted_mean(jnp.asarray(g)))
                    for g in grads])
    got = tsim.confidence_weighted_mean(_t(grads)).numpy()
    _close(got, ref)
    np.testing.assert_array_equal(got[:, 3], grads[:, :, 3].mean(axis=1))


@pytest.mark.parametrize("n_other", [None, 3, 2])
def test_scaling_weights_and_consistency_match_jax(grads, n_other):
    sims = [jsim.pairwise_cosine_norm_similarity(jnp.asarray(g))
            for g in grads]
    tsims = tsim.pairwise_cosine_norm_similarity(_t(grads))
    ref = np.stack([np.asarray(jsim.compute_scaling_weights(s, n_other))
                    for s in sims])
    _close(tsim.compute_scaling_weights(tsims, n_other).numpy(), ref)
    for thr in (0.0, 0.05, 0.5):
        ref = np.stack([np.asarray(jsim.identify_consistent_views(s, thr))
                        for s in sims])
        np.testing.assert_array_equal(
            tsim.identify_consistent_views(tsims, thr).numpy(), ref)


def test_weight_function_matches_jax():
    s = np.concatenate([np.linspace(-1.5, 1.5, 301),
                        [-1.0, -1e-7, 0.0, 1e-7, 1.0]]).astype(np.float32)
    _close(tsim.weight_function(_t(s)).numpy(),
           np.asarray(jsim.weight_function(jnp.asarray(s))))


def test_select_views_match_jax():
    """Per-view per-joint errors with ties and columns of too few hits,
    for B scenes at once against one JAX call per scene."""
    rng = np.random.default_rng(2)
    err = np.round(rng.uniform(0, 5, (B, 6, 9)), 0).astype(np.float32)
    got = tsim.select_views(_t(err), threshold=2.5, min_views=4)
    for b in range(B):
        ref = jsim.select_views(jnp.asarray(err[b]), 2.5, 4)
        for t, j in zip(got, ref):
            np.testing.assert_array_equal(t[b].numpy(), np.asarray(j))


def test_select_consistent_views_match_jax(grads):
    for k in (1, 2, 4):
        ref = np.stack([np.asarray(jsim.select_consistent_views(
            jnp.asarray(g), k)) for g in grads])
        np.testing.assert_array_equal(
            tsim.select_consistent_views(_t(grads), k).numpy(), ref)


def test_early_stopping_classes_match_jax():
    """Each registry class and EarlyStopping, fed one loss sequence that
    falls, plateaus, repeats a 4-loss pattern and rises."""
    seq = ([1.0 - 0.05 * i for i in range(10)] + [0.5] * 6
           + [0.3, 0.2, 0.31, 0.4] * 3 + [0.6 + 1e-7 * i for i in range(12)])
    makers = [(jstop.EarlyStopping(patience=3), tstop.EarlyStopping(patience=3)),
              (jstop.EarlyStopping(), tstop.EarlyStopping())]
    makers += [(jstop.early_stopping_strategy[k](),
                tstop.early_stopping_strategy[k]())
               for k in jstop.early_stopping_strategy]
    assert list(tstop.early_stopping_strategy) == \
        list(jstop.early_stopping_strategy)
    fired = 0
    for j, t in makers:
        outs = [(j(x), t(x)) for x in seq]
        assert [a for a, _ in outs] == [b for _, b in outs], type(t).__name__
        fired += sum(b for _, b in outs)
    assert fired > 0
