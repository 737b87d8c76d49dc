"""The plain reference against the program on the CPU at a small size, and
the control (the reference in TF32) against the reference, as the cells'
limits are set from them on the card."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import REPO
from reference.fit import Reference
from skbench import check, inputs, spec as specs


def small(name: str, iterations: int) -> dict:
    cfg = json.loads((REPO / f"benchmark/configs/{name}.json").read_text())
    cfg.update(width=128, height=112, iterations=iterations)
    return cfg


def program_fit(cfg, cams, init, p2d, gt):
    from skbench import program

    trainer = program.make_trainer(cfg, "cpu")
    cam = program.cameras(cams)
    out = []
    for f in range(len(init)):
        params, history = trainer.optimize_scene(init[f], p2d[f], cam, gt[f],
                                                 lean=True)
        out.append((params.xyz.numpy(), history.losses[-1].numpy()))
    return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]))


@pytest.mark.parametrize("name", ["h36m", "panoptic"])
def test_reference_follows_the_program(name):
    """Two macro steps: poses within 1e-3 mm and the last step's losses
    within 1e-5 relative (rounding alone; the geometry and the losses are
    computed in other orders)."""
    cfg = small(name, 8)
    cams = inputs.rig(cfg)
    init, gt, p2d = inputs.frames(cfg, cams, 2 ** 31 + 3, inputs.WINDOW, 0, 2)
    xyz, losses = program_fit(cfg, cams, init, p2d, gt)
    ref_xyz, ref_losses = Reference(cfg, cams).fit(init, p2d)
    assert check.frame_gaps_mm(xyz, ref_xyz).max() < 1e-3
    assert np.abs(xyz - init).max() > 1.0          # the fit moved
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)


def test_control_in_tf32_parts_from_the_reference():
    """The control, every product's operands rounded to TF32, put in the
    program's place, comes out not correct by the cell's own numbers and
    limits, where the reference itself passes: at 128×112 over 100
    iterations."""
    cfg = small("h36m", 100)
    cams = inputs.rig(cfg)
    init, _, p2d = inputs.frames(cfg, cams, 5, inputs.WINDOW, 0, 3)
    ref = Reference(cfg, cams).fit(init, p2d)[0]
    control = Reference(cfg, cams, precision="tf32").fit(init, p2d)[0]
    spec = specs.load("h36m.chain32")
    picked = [0, 1, 2]
    checked, _ = check.numbers(spec, dict(zip(picked, control)), picked, ref)
    assert not check.passed(checked)
    assert checked["xyz_gap_p60_mm"][0] > spec.cell["limits"][
        "xyz_gap_p60_mm"]
    assert check.passed(check.numbers(spec, dict(zip(picked, ref)), picked,
                                      ref)[0])


def test_tf32_rounds_to_ten_mantissa_bits():
    import torch

    from reference.fit import _tf32

    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10),
                      1.0 + 2 ** -11 + 2 ** -20])
    assert _tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10),
                                 1.0 + 2 ** -10]


def test_the_percentile_passes_a_few_parted_frames_and_not_half():
    sound = [0.004, 0.006, 0.003, 0.005, 0.002, 0.007, 0.004, 0.005]
    parted = sound[:5] + [3.0, 1.2, 0.9]
    half = sound[:4] + [40.0] * 4
    assert check.quantile_mm(sound) == 0.005
    assert check.quantile_mm(parted) == 0.006
    assert check.quantile_mm(half) == 40.0
    assert np.isnan(check.quantile_mm(sound[:7] + [float("nan")]))


def test_sample_is_drawn_from_the_seed():
    units = [(first, 32) for first in range(0, 320, 32)]
    a = check.sample(units, 16, 99)
    assert a == check.sample(units, 16, 99) and len(set(a)) == 16
    assert a != check.sample(units, 16, 100)
    assert check.sample([(0, 5)], 16, 99) == list(range(5))


HALVES = {"first": lambda k, n, i: 2 * k < n,
          "second": lambda k, n, i: 2 * k >= n,
          "even": lambda k, n, i: i % 2 == 0,
          "odd": lambda k, n, i: i % 2 == 1}


@pytest.mark.parametrize("size", [1, 4, 8, 32, 128])
def test_a_spoiled_half_of_every_unit_is_half_the_sample(size):
    """Whichever half of every unit a fault spoils, the first, the second,
    the even or the odd frames, it holds at least half of the sample on
    every seed, so the 60th percentile reads a spoiled frame."""
    units = [(first, size) for first in range(0, max(size * 3, 300), size)]
    for seed in range(40):
        picked = check.sample(units, 16, seed + 2 ** 31)
        assert len(set(picked)) == 16
        for name, spoiled in HALVES.items():
            if size == 1 and name in ("first", "second"):
                continue    # a unit of one frame has no halves
            bad = sum(spoiled(i % size, size, i) for i in picked)
            assert bad >= 8, (name, seed, bad)
            gaps = [40.0 if spoiled(i % size, size, i) else 0.004
                    for i in picked]
            assert check.quantile_mm(gaps) == 40.0
