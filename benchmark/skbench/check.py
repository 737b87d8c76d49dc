"""How ``correct`` is decided: a sample of the window's frames, drawn from
the seed, each fitted again by the plain reference from the same inputs.
Per frame, the widest gap between a joint the program returned and the
reference's; compared, the 60th percentile (nearest rank) of those over
the sample, against the cell's limit. Every frame the window completed
must also have a finite pose.

Why a percentile and not the widest frame: 500 Adam steps amplify
rounding. On a few frames of a sample, two sound fits (the reference
against itself with the initial pose moved by one ulp) part by
millimetres (PERF.md), as far as the TF32 control's widest frame. The
control moves nearly every frame. The 60th percentile passes up to 40% of
frames parted so. The sample is drawn in equal shares from four strata
(the first or second half of a frame's unit, its even or odd index), so a
fault that spoils one half of every unit, either way, spoils half the
sample and fails it on every seed."""

from __future__ import annotations

import numpy as np

from skbench import inputs

NONFINITE_LIMIT = 0
QUANTILE = 60


def strata(units) -> list:
    """The window's frames in four strata, by (second half of its unit,
    odd index); a unit of one frame lies in its first half. ``units`` holds
    (first frame, frames) of each unit."""
    out = [[], [], [], []]
    for first, n in sorted(units):
        for k in range(n):
            out[2 * (2 * k >= n) + (first + k) % 2].append(first + k)
    return [s for s in out if s]


def sample(units, count: int, seed: int) -> list:
    """``count`` frames of the window drawn from the seed, in order, in
    equal shares from each stratum that has frames; what a short stratum
    cannot give the others give."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed % 2 ** 64, inputs.SAMPLE]))
    groups = strata(units)
    left = min(count, sum(map(len, groups)))
    take = [0] * len(groups)
    while left:
        room = [i for i, g in enumerate(groups) if take[i] < len(g)]
        share = max(left // len(room), 1)
        for i in room:
            add = min(share, len(groups[i]) - take[i], left)
            take[i] += add
            left -= add
    picked = []
    for g, t in zip(groups, take):
        picked += [g[i] for i in rng.choice(len(g), size=t, replace=False)]
    return sorted(picked)


def reference_fit(config, cams, seed, frames, device, precision="float32",
                  block: int = 16, nudge: bool = False):
    """The reference's poses (len(frames), N, 3) of the window's
    ``frames``, made again from the seed, ``block`` frames at a time;
    with ``nudge`` from initial poses moved by one ulp (a second sound
    fit, for the look at how far two such fits part)."""
    from reference.fit import Reference

    ref = Reference(config, cams, device, precision)
    out = []
    for at in range(0, len(frames), block):
        part = [inputs.frames(config, cams, seed, inputs.WINDOW, i, 1)
                for i in frames[at:at + block]]
        init = np.concatenate([p[0] for p in part])
        if nudge:
            init = np.nextafter(init, np.float32(np.inf))
        p2d = np.concatenate([p[2] for p in part])
        out.append(ref.fit(init, p2d)[0])
    return np.concatenate(out)


def frame_gaps_mm(xyz, ref_xyz) -> np.ndarray:
    """Per frame of (F,N,3) poses, the widest distance between a joint and
    the reference's, mm (NaN where a pose is not finite)."""
    d = np.linalg.norm(np.asarray(xyz, np.float64)
                       - np.asarray(ref_xyz, np.float64), axis=-1)
    return np.where(np.isfinite(d).all(axis=-1), d.max(axis=-1), np.nan)


def quantile_mm(gaps, q: float = QUANTILE) -> float:
    """The nearest-rank ``q``-th percentile of per-frame gaps; NaN (which
    fails every limit) where a frame is not finite."""
    g = np.asarray(gaps, np.float64)
    if not np.isfinite(g).all():
        return float("nan")
    return float(np.sort(g)[max(int(np.ceil(q / 100 * len(g))), 1) - 1])


def numbers(spec, xyz: dict, picked, ref) -> tuple[dict, np.ndarray]:
    """({number: (value, limit)}, the picked frames' gaps) of poses
    ``xyz`` (frame → (N,3)) against the reference's ``ref`` of the
    ``picked`` frames."""
    nonfinite = sum(not np.isfinite(v).all() for v in xyz.values())
    gaps = frame_gaps_mm(np.stack([xyz[i] for i in picked]), ref)
    return ({"nonfinite_frames": (nonfinite, NONFINITE_LIMIT),
             "xyz_gap_p60_mm": (quantile_mm(gaps),
                                spec.cell["limits"]["xyz_gap_p60_mm"])},
            gaps)


def check(spec, cams, seed, xyz: dict, units, device) -> tuple[dict,
                                                              np.ndarray]:
    """``numbers`` of a run: ``xyz`` holds every completed frame's pose,
    ``units`` (first frame, frames) of each completed unit."""
    picked = sample(units, spec.cell["check_frames"], seed)
    ref = reference_fit(spec.config, cams, seed, picked, device)
    return numbers(spec, xyz, picked, ref)


def passed(checked: dict) -> bool:
    """Whether every number of ``numbers`` is within its limit."""
    return all(limit is not None and np.isfinite(value) and value <= limit
               for value, limit in checked.values())
