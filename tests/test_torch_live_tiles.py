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


# (V, n_tiles, grid, R): the benchmark's cells on an H100's 396 resident
# tile-kernel blocks, then edge shapes: one view, lists of one tile, and
# Occlusion-Person's 1280×720 frames
H36M_TILES, PANOPTIC_TILES, OP_TILES = 63 * 63, 120 * 68, 80 * 45
RUN_SHAPES = {
    "h36m.chain32": (4, H36M_TILES, 396, 2),
    "panoptic.chain32": (4, PANOPTIC_TILES, 396, 7),
    "panoptic.batch128": (512, PANOPTIC_TILES, 396, 48),
    "h36m.batch8": (32, H36M_TILES, 396, 7),
    "one_view": (1, H36M_TILES, 396, 2),
    "one_tile": (4, 1, 396, 1),
    "one_tile_batch": (512, 1, 396, 1),
    "op_1280x720": (4, OP_TILES, 396, 2),
    "op_1280x720_batch": (512, OP_TILES, 396, 48),
}


@pytest.mark.parametrize("name", list(RUN_SHAPES))
def test_run_length_follows_the_call_shape(name):
    """K1's run length is a pure function of the call's shape: the measured
    table's R at each cell, never longer than a view's list can be, and
    never shorter for more views or longer for a larger grid."""
    V, n_tiles, grid, want = RUN_SHAPES[name]
    R = cr.run_length(V, n_tiles, grid)
    assert R == want
    assert 1 <= R <= min(cr.MAX_RUN, n_tiles)
    assert cr.run_length(2 * V, n_tiles, grid) >= R
    assert cr.run_length(V, n_tiles, 2 * grid) <= R


@pytest.mark.parametrize("run", [0, cr.MAX_RUN + 1])
def test_forced_run_length_outside_its_range_raises(run):
    """The kernel call takes a forced run length of 1 to MAX_RUN only, and
    says so before it looks for a card."""
    pack, p1s, p2s, img = kernel_probe.probe_inputs(112, 96, n_views=2,
                                                    device="cpu")
    with pytest.raises(ValueError, match="run length"):
        cr._launch(pack, p1s, p2s, img, False, True, run=run)


def test_k1_variants_reads_a_sources_entry_point():
    """The variant timer calls a build with a run length only where the
    source's C entry point takes one, and splits only the single-entry
    tile kernel (the tree's takes runs, so it has no such text)."""
    from pathlib import Path

    from skelsplat_tpu_torch.ops import _build
    from skelsplat_tpu_torch.tools import k1_variants as kv

    src = (Path(_build.CSRC) / "raster_loss.cu").read_text()
    assert kv.takes_run(src)
    assert not kv.takes_run(src.replace("int with_grad, int run,",
                                        "int with_grad,"))
    with pytest.raises(ValueError, match="single-entry"):
        kv.split_sources(src)


@pytest.mark.parametrize("variant", ["no_sum", "no_ticket", "pack_once",
                                     "rows_once", "bare"])
def test_k1_variants_split_patches_its_parts(variant):
    """Each variant of the entry split changes the texts it names and keeps
    the rest of the source."""
    from skelsplat_tpu_torch.tools import k1_variants as kv

    parts = ["// head", kv._PACK, kv._ROWS, kv._TICKET, "// tail"]
    src = "\n".join(parts)
    out = kv.split_sources(src)[variant]
    assert out != src and out.startswith("// head\n") \
        and out.endswith("\n// tail")
    for old, new in kv.SPLIT[variant]:
        assert old not in out.replace(new, "") and new in out
    assert kv.split_sources(src)["before"] == src


def test_k1_variants_needs_a_card():
    """The variant timer times kernels and raises on a host with no card
    before it builds anything."""
    from skelsplat_tpu_torch.tools import k1_variants as kv

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        kv.main([])


def test_k1_variants_buffers_and_poison():
    """The variant timer's shared buffers are the wrapper's sizes, and its
    poison marks every output unwritten."""
    from skelsplat_tpu_torch.ops import _build
    from skelsplat_tpu_torch.tools import k1_variants as kv

    x = kernel_probe.probe_inputs(112, 96, n_views=2, n_joints=15,
                                  device="cpu")
    b = kv.buffers(x)
    nt = _build.n_tiles(112, 96)
    assert b["dg"].shape == (2, 15, cr.N_GRAD)
    assert b["part_dg"].numel() == 2 * 15 * nt * cr.N_GRAD
    assert b["live_idx"].numel() == b["part_s"].numel() == 2 * nt
    assert b["counts"].numel() == 4
    kv.poison(b)
    assert bool(b["S"].isnan().all()) and bool(b["dg"].isnan().all())
    assert bool((b["C"] == -1).all())
