"""Occlusion-Person as the benchmark's ``op`` configuration
(``benchmark/configs/op.json``): the port's fit at its settings against
the benchmark's plain reference (``benchmark/reference/fit.py``) on the
CPU at a small size, its frozen rotations, the file against the port's
copy of upstream's YAML and the port's joint tables, the harness's new
cells, and the ``k1_slot_bound`` reader."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference.fit import Reference  # noqa: E402
from skbench import check, inputs, program  # noqa: E402
from skbench import spec as specs  # noqa: E402

SMALL = {"width": 128, "height": 112, "iterations": 8}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops on one torch thread, as the other port tests run
    under the parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def op_config(**changes) -> dict:
    cfg = json.loads((BENCH / "configs/op.json").read_text())
    cfg.update(changes)
    return cfg


def frames(cfg, seed: int, count: int):
    cams = inputs.rig(cfg)
    init, gt, p2d = inputs.frames(cfg, cams, seed, inputs.WINDOW, 0, count)
    return cams, init, gt, p2d


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 22])
def test_op_fit_follows_the_reference(seed):
    """Two frames at op.json's settings, cut to 128×112 and 8 iterations
    (two macro steps), through ``SceneTrainer.optimize_scene`` on the CPU
    against the reference: poses within 1e-3 mm and the last step's
    per-view losses within 1e-5 relative, as the benchmark's tests hold
    the other two configurations. Both compute in float32 from the same
    inputs, but the geometry and the loss sums run in other orders, so
    they part by rounding alone: a float32 ulp of a ~1,000 mm coordinate
    is 6e-5 mm, and two steps carry a few of them. On these frames the
    reference computed in TF32 parts from itself by 1.7 and 52 mm and
    0.4% and 3% of a loss, and at scale modifier 1.0 by 55-128 mm; the fit
    itself moves joints by over 1 mm."""
    cfg = op_config(**SMALL)
    cams, init, gt, p2d = frames(cfg, seed, 2)
    trainer = program.make_trainer(cfg, "cpu")
    cam = program.cameras(cams)
    xyz, losses = [], []
    for f in range(len(init)):
        params, history = trainer.optimize_scene(init[f], p2d[f], cam, gt[f],
                                                 lean=True)
        xyz.append(params.xyz.numpy())
        losses.append(history.losses[-1].numpy())
    xyz, losses = np.stack(xyz), np.stack(losses)
    ref_xyz, ref_losses = Reference(cfg, cams).fit(init, p2d)
    assert check.frame_gaps_mm(xyz, ref_xyz).max() < 1e-3
    assert np.abs(xyz - init).max() > 1.0
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)


@pytest.mark.parametrize("entry", ["scene", "chain", "batch"])
def test_rotations_stay_at_their_start_under_rotation_lr_zero(entry):
    """At op.json's ``rotation_lr`` 0, Adam leaves every quaternion
    bitwise at its initial value (identity) through each of the trainer's
    entry points, while the scales, at ``scaling_lr`` 5e-3, move; the
    extremity joints start at 1.25 × the log-scale."""
    cfg = op_config(**SMALL)
    assert cfg["rotation_lr"] == 0.0 and cfg["scaling_lr"] > 0
    cams, init, gt, p2d = frames(cfg, 3, 2)
    trainer = program.make_trainer(cfg, "cpu")
    cam = program.cameras(cams)
    if entry == "scene":
        params = trainer.optimize_scene(init[0], p2d[0], cam, gt[0],
                                        lean=True)[0]
        start = trainer.model.init(init[0], device="cpu")
    elif entry == "chain":
        params = trainer.optimize_scene_chain(
            [trainer.host_inputs(init[f], p2d[f], cam, gt[f])
             for f in range(2)], lean=True)[0]
        start = trainer.model.init(init, device="cpu")
    else:
        params = trainer.optimize_scene_batch(
            init, p2d, program.stacked_cameras(cam, 2), gt, lean=True)[0]
        start = trainer.model.init(init, device="cpu")
    assert torch.equal(params.quats, start.quats)
    assert bool((start.quats[..., 0] == 1).all())
    assert not torch.equal(params.log_scales, start.log_scales)
    boosted = np.float32(3.0) * np.float32(1.25)
    ext = cfg["extremity_joints"]
    assert bool((start.log_scales[..., ext, :] == boosted).all())
    rest = [j for j in range(cfg["joints"]) if j not in ext]
    assert bool((start.log_scales[..., rest, :] == 3.0).all())


def test_op_config_matches_upstream_and_the_port_tables():
    """op.json has h36m.json's keys, and agrees with the port's copy of
    upstream's ``configs/occlusion-person.yaml`` in every key the two
    share, with the port's Occlusion-Person extremity joints, limb pairs
    and joint count, and with its bench preset's frame size and scale
    modifier."""
    from skelsplat_tpu_torch import bench
    from skelsplat_tpu_torch.core.gaussians import EXTREMITY_JOINTS, N_JOINTS
    from skelsplat_tpu_torch.losses import LIMB_PAIRS

    cfg = op_config()
    h36m = json.loads((BENCH / "configs/h36m.json").read_text())
    assert list(cfg) == list(h36m)
    upstream = yaml.safe_load((REPO / "skelsplat_tpu_torch/config/configs/"
                               "occlusion-person.yaml").read_text())
    shared = {key: value for group in ("training", "optimization", "model")
              for key, value in upstream[group].items() if key in cfg}
    assert {"scaling", "scaling_modifier", "iterations", "position_lr_init",
            "position_lr_final", "scaling_lr", "rotation_lr", "opacity_lr",
            "loss_function", "consistency_loss", "lambda_consistency",
            "early_stopping", "accumulation_steps"} <= set(shared)
    assert {key: cfg[key] for key in shared} == shared
    assert cfg["views"] == upstream["dataset"]["nviews"]
    assert cfg["dataset"] == "occlusion-person"
    assert cfg["joints"] == N_JOINTS["occlusion-person"]
    assert cfg["extremity_joints"] == EXTREMITY_JOINTS["occlusion-person"]
    assert [tuple(p) for p in cfg["limb_pairs"]] == list(
        LIMB_PAIRS["occlusion-person"])
    w, h, n, scene, modifier, dropout = bench.PRESETS["op"]
    assert (cfg["width"], cfg["height"], cfg["joints"], cfg["dataset"],
            cfg["scaling_modifier"], cfg["dropout"]) == (w, h, n, scene,
                                                         modifier, dropout)
    assert cfg["reduced"] == []


def test_the_harness_finds_the_new_cells():
    """``op.chain32`` and ``h36m.batch512`` load by name with their
    configuration, traffic and limits, and report ``frames_per_s``, K1's
    roofline share and slot bound; the batch also its device idle share."""
    op = specs.load("op.chain32")
    assert op.config["joints"] == 15 and op.traffic["kind"] == "chain"
    assert op.traffic["group"] == 32 and op.cell["check_frames"] == 16
    batch = specs.load("h36m.batch512")
    assert batch.config["joints"] == 17
    assert (batch.traffic["kind"], batch.traffic["batch"],
            batch.traffic["in_flight"]) == ("batch", 512, 2)
    assert batch.cell["limits"]["xyz_gap_p60_mm"] == 0.1
    for cell, extra in ((op, set()), (batch, {"device_idle_share"})):
        assert [m["name"] for m in cell.end_to_end] == ["frames_per_s",
                                                        "setup_s"]
        names = {m["name"] for m in cell.per_layer}
        assert {"k1_roofline", "k1_device_share", "k1_slot_bound",
                "step_device_ms_per_frame"} | extra <= names
        assert ("device_idle_share" in names) == bool(extra)
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))


SLOT_RECORDS = {
    # label → calls of the window's units, and the mean slot bound
    "op": ({"16": 4000}, 16.0),
    "h36m": ({"24": 4000}, 24.0),
    "mixed": ({"16": 250, "24": 500, "32": 250}, 24.0),
    "no_calls": ({}, None),
    "no_counter": (None, None),
}


@pytest.mark.parametrize("case", list(SLOT_RECORDS))
def test_k1_slot_bound_reads_the_mean_over_the_windows_calls(case):
    """The reader on a made-up record of a window's program trace: the
    mean slot bound over the K1 calls its counter holds by label; nothing
    where no call was counted, or where the program has no such counter
    (an older checkout's window has no label for it)."""
    by_label, want = SLOT_RECORDS[case]
    labels = {"graph_launches": {"step": 125}}
    if by_label is not None:
        labels["k1_slot_bound"] = by_label
    record = {"window": None, "program_trace": {"by_label": labels}}
    read = specs.load("op.chain32").reader("k1_slot_bound")
    assert read(record) == want
    assert read({"window": None, "program_trace": None}) is None
