"""K1's live-tile list in its plain version (CPU): the count against
``tools/roofline.py::tile_activity`` (held against the JAX package's rects
and spans in test_torch_tools.py), the order, and the slot masks against a
per-slot numpy evaluation of the kernel's tile tests, on H36M-size frames
with ragged widths, a culled slot, an all-dead view and 15 or 19 joints."""

import numpy as np
import pytest
import torch

from skelsplat_tpu_torch.ops import cuda_raster as cr
from skelsplat_tpu_torch.tools import kernel_probe, roofline

W, H = 1002, 1000
RAGGED = (1002, 1000, 1002, 1000)


def _numpy_masks(pack, H, W):
    """(V, n_tiles) uint64 slot masks, slot by slot in numpy float32."""
    pk = pack.numpy()
    V, N, _ = pk.shape
    by = np.arange(-(-H // 16), dtype=np.float32)[:, None]
    bx = np.arange(-(-W // 16), dtype=np.float32)[None, :]
    y0, x0 = by * np.float32(16), bx * np.float32(16)
    masks = np.zeros((V, by.size * bx.size), np.uint64)
    for v in range(V):
        for i in range(N):
            s = pk[v, i]
            rend = ((s[cr.IDX_OPA] > 0) & (bx >= s[cr.IDX_RX0])
                    & (bx < s[cr.IDX_RX1]) & (by >= s[cr.IDX_RY0])
                    & (by < s[cr.IDX_RY1]))
            gt = ((s[cr.IDX_GY0] < y0 + 16) & (s[cr.IDX_GY1] > y0)
                  & (s[cr.IDX_GX0] < x0 + 16) & (s[cr.IDX_GX1] > x0))
            masks[v] |= (rend.reshape(-1).astype(np.uint64) << np.uint64(i))
            masks[v] |= (gt.reshape(-1).astype(np.uint64)
                         << np.uint64(32 + i))
    return masks


def _case(name):
    if name == "ragged":
        return kernel_probe.probe_inputs(W, H, device="cpu", widths=RAGGED)
    if name == "behind_camera":
        return kernel_probe.probe_inputs(W, H, device="cpu",
                                         behind_camera=True, perturb=True)
    if name == "dead_view":
        pack, p1s, p2s, img = kernel_probe.probe_inputs(W, H, device="cpu",
                                                        widths=RAGGED)
        pack, p1s = kernel_probe.keep_slots(pack, p1s, 0, views=[2])
        return pack, p1s, p2s, img
    n = int(name[1:])
    return kernel_probe.probe_inputs(W, H, n_joints=n, device="cpu")


@pytest.mark.parametrize("name", ["ragged", "behind_camera", "dead_view",
                                  "n15", "n19"])
def test_live_list_counts_orders_and_masks(name):
    pack, p1s, p2s, img = _case(name)
    V = pack.shape[0]
    idx, mask, n = cr.live_tiles_plain(pack, H, W)
    n_tiles = -(-W // 16) * -(-H // 16)
    assert idx.shape == mask.shape == (V, n_tiles) and n.shape == (V,)
    assert idx.dtype == n.dtype == torch.int32 and mask.dtype == torch.int64
    act = roofline.tile_activity(pack, img, (H, W))
    assert n.tolist() == act["active_tiles"].tolist()
    ref = _numpy_masks(pack, H, W)
    for v in range(V):
        k = int(n[v])
        live = np.flatnonzero(ref[v])
        assert k == live.size
        # ascending live tiles first, then -1; masks beside them, then 0
        np.testing.assert_array_equal(idx[v, :k].numpy(), live)
        assert (idx[v, k:] == -1).all() and (mask[v, k:] == 0).all()
        np.testing.assert_array_equal(mask[v, :k].numpy().view(np.uint64),
                                      ref[v, live])
    if name == "dead_view":
        assert int(n[2]) == 0 and (n[[0, 1, 3]] > 0).all()
    else:
        assert (n > 0).all() and (n < n_tiles // 4).all()
    if name == "behind_camera":
        # the culled slot (opacity 0, sorted last in view 0) renders nowhere
        assert not (mask[0] & (1 << (pack.shape[1] - 1))).any()
        assert float(pack[0, -1, cr.IDX_OPA]) == 0.0


def test_wrappers_return_the_live_list_and_zero_a_dead_view():
    """On the CPU both wrappers give the plain list, and a view with no live
    tile gets S = C = dg = 0 exactly (small frame: the plain K1 is dense)."""
    w, h = 112, 96
    pack, p1s, p2s, img = kernel_probe.probe_inputs(w, h, n_views=3,
                                                    device="cpu")
    pack, p1s = kernel_probe.keep_slots(pack, p1s, 0, views=[1])
    S, C, dg, live = cr.raster_loss_grad(pack, p1s, p2s, img, False,
                                         return_live=True)
    S2, C2, live2 = cr.raster_loss(pack, p1s, p2s, img, False,
                                   return_live=True)
    ref = cr.live_tiles_plain(pack, h, w)
    for got in (live, live2):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert ref[2].tolist()[1] == 0 and ref[2][[0, 2]].min() > 0
    assert float(S[1]) == 0.0 and int(C[1]) == 0
    assert float(dg[1].abs().max()) == 0.0
    assert (S[[0, 2]] > 0).all() and (C[[0, 2]] > 0).all()
    assert torch.equal(S, S2) and torch.equal(C, C2)
    # without return_live the wrappers keep their outputs
    assert len(cr.raster_loss_grad(pack, p1s, p2s, img, False)) == 3
    assert len(cr.raster_loss(pack, p1s, p2s, img, False)) == 2
