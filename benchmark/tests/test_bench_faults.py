"""A run with the timed path broken underneath: the harness's look for a
card skipped (the CPU), the rest of a run driven as it is, and ``correct``
false for each fault a cell of this benchmark can have. A step that
returns its state unchanged; half of a batch left out, its results those
of the other half; every answer altered where it is produced; a pose that
is not finite. (No cell runs across cards, so no exchange between them
can be left out.)"""

from __future__ import annotations

import pytest

from conftest import run_cell


@pytest.fixture
def trainer_cls():
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer

    return SceneTrainer


@pytest.mark.parametrize("kind", ["chain", "batch", "online"])
def test_a_step_that_leaves_the_state_unchanged(tiny_root, capsys,
                                                monkeypatch, trainer_cls,
                                                kind):
    monkeypatch.setattr(trainer_cls, "_steps",
                        lambda self, run_step, st, *a: None)
    out = run_cell(tiny_root, f"tiny.{kind}", capsys)
    assert out["correct"] is False
    assert out["checked"]["xyz_gap_p60_mm"]["value"] > 1.0


def _half_left_out(real, keep):
    """``optimize_scene_batch`` that fits only the frames ``keep(B)``
    picks and returns, for each frame left out, a kept frame's result."""

    def half(self, init, p2d, cams, gt=None, lean=False):
        kept = keep(len(init))
        params, history = real(self, init[kept], p2d[kept], cams.map(
            lambda x: x[kept]), None if gt is None else gt[kept], lean=lean)
        at = {f: k for k, f in enumerate(kept)}
        idx = [at.get(i, i % len(kept)) for i in range(len(init))]
        return (params.map(lambda x: x[idx]),
                type(history)(*(None if f is None else f[idx] if f.dim()
                                else f for f in (history.losses,
                                                 history.error,
                                                 history.error_rel,
                                                 history.stopped_at,
                                                 history.hist8))))

    return half


FIRST_HALF = {"first": lambda B: list(range(-(-B // 2))),
              "even": lambda B: list(range(0, B, 2))}


@pytest.mark.parametrize("cell,half,seed", [
    ("tiny.batch", "first", 2 ** 31 + 11)] + [
    ("tiny.batch8", half, seed) for half in sorted(FIRST_HALF)
    for seed in (5, 2 ** 31 + 17, 2 ** 32 + 40)])
def test_half_of_the_batch_left_out(tiny_root, capsys, monkeypatch,
                                    trainer_cls, cell, half, seed):
    """The fitted half may be the first or the even frames of each batch;
    ``tiny.batch8``'s batches of 8 are larger than its sample of 4, over
    several batches, and the run fails on every seed."""
    monkeypatch.setattr(trainer_cls, "optimize_scene_batch", _half_left_out(
        trainer_cls.optimize_scene_batch, FIRST_HALF[half]))
    out = run_cell(tiny_root, cell, capsys, seconds=2.0, seed=seed)
    assert out["attempted"] >= 16
    assert out["correct"] is False


@pytest.mark.parametrize("kind", ["chain", "batch", "online"])
@pytest.mark.parametrize("shift", [0.2, float("nan")])
def test_an_answer_altered_where_it_is_produced(tiny_root, capsys,
                                                monkeypatch, trainer_cls,
                                                kind, shift):
    """Each scene's last Adam step moves one coordinate of one joint by
    ``shift`` mm (or makes it NaN)."""
    real = trainer_cls._results

    def altered(self, st, pose_3d_gt, lean):
        params, history = real(self, st, pose_3d_gt, lean)
        xyz = params.xyz.clone()
        xyz[..., 0, 0] += shift
        return type(params)(xyz, params.log_scales, params.quats,
                            params.opacity_logit), history

    monkeypatch.setattr(trainer_cls, "_results", altered)
    out = run_cell(tiny_root, f"tiny.{kind}", capsys)
    assert out["correct"] is False
    if shift != shift:
        assert out["failed"] == out["attempted"]
