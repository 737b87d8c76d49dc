"""The port's single-device forward check (``graft_entry.entry``) against
the root ``__graft_entry__.entry`` of the JAX package: the same seeded
scene, the same mean fused view loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from skelsplat_tpu.core.gaussians import SkeletonModel
from skelsplat_tpu.engine.trainer import TrainSettings, init_params_jnp
from skelsplat_tpu.ops import heatmaps as jhm
from skelsplat_tpu.ops.fused import make_fused_view_loss
from skelsplat_tpu_torch import graft_entry as tentry

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops on one torch thread: under the test run's
    parallel workers, an intra-op thread per core in every worker contends
    for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_forward(width, height):
    """The JAX entry's forward at a ``width``×``height`` frame (the entry
    itself is fixed at 512×512)."""
    init, _, p2d, cams_b = jentry._synthetic_inputs(1, width, height)
    view_loss = make_fused_view_loss(SkeletonModel("h36m", 17, scaling=3.0),
                                     TrainSettings(), width, height)
    camsj = jax.tree.map(jnp.asarray, cams_b)
    p2dj = jnp.asarray(p2d[0])

    def forward(initial_pose):
        params = init_params_jnp(initial_pose, "h36m", 3.0, 1.0)
        spec = jhm.heatmap_spec(params.xyz, params.covariance(), p2dj, camsj,
                                width, height,
                                drop_mask=jnp.zeros(p2dj.shape[:2], bool))
        return jnp.mean(jax.vmap(view_loss, in_axes=(None, 0, 0, 0))(
            params, camsj, spec, p2dj))

    return forward, (jnp.asarray(init[0]),)


def _port_value(forward, args):
    with torch.no_grad():
        out = forward(*args)
    assert out.shape == () and out.dtype == torch.float32
    return float(out)


def test_synthetic_inputs_match():
    j = jentry._synthetic_inputs(2, 96, 80)
    t = tentry._synthetic_inputs(2, 96, 80, device="cpu")
    for a, b in zip(j[:3], t[:3]):
        assert np.array_equal(a, b)
    for f in ("view4", "full4", "cam_center", "width", "height"):
        assert np.array_equal(getattr(t[3], f).numpy(),
                              np.asarray(getattr(j[3], f))), f


def test_small_frame_forward_matches_jax():
    jf, jargs = _jax_forward(96, 80)
    tf, targs = tentry.scene_forward(96, 80, device="cpu")
    assert np.array_equal(targs[0].numpy(), np.asarray(jargs[0]))
    want = float(jax.jit(jf)(*jargs))
    assert want > 0
    assert _port_value(tf, targs) == pytest.approx(want, rel=RTOL)


def test_entry_matches_the_jax_entry():
    """The 512×512 entry itself, in both packages."""
    jf, jargs = jentry.entry()
    tf, targs = tentry.entry(device="cpu")
    assert np.array_equal(targs[0].numpy(), np.asarray(jargs[0]))
    want = float(jax.jit(jf)(*jargs))
    assert _port_value(tf, targs) == pytest.approx(want, rel=RTOL)
