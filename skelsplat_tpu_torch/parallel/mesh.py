"""Multi-GPU optimization over a (scenes × views) mesh of ranks
(counterpart of ``skelsplat_tpu/parallel/mesh.py``).

* ``scenes``: independent frames split over the ranks; no communication
  until each mesh batch's results are assembled once, at its end.
* ``views``: each rank renders its slice of every scene's cameras (the
  kernel's work: K1 runs over the rank's own views alone), then the ranks
  of a ``views`` group gather the per-view losses and gradients, O(V·N·11)
  floats, the only collective of a macro step. Every rank then runs the
  trainer's own macro loop (``SceneTrainer._run``, with the same
  ``compose_macro``) on the gathered summaries, so early stopping, general
  accumulation windows and the mean-xyz / last-view fusion are those of
  one device, and the parameters stay replicated along ``views``.

A gather is one ``all_reduce`` (sum) of a zero buffer into which each
rank writes its own block, over the buffer's bits as int32: one code path
for NCCL and for gloo on CUDA tensors (gloo's ``all_gather`` does not take
them), and x + 0 in integers leaves every float bit, signed zeros
included, as it was. A gather does no arithmetic and K1's result for a
view does not depend on which views share its launch, so each scene of a
mesh run is bitwise that scene of ``SceneTrainer.optimize_scene_batch``.

The mesh's prepare is the trainer's vectorized ``_prepare_batch`` (one
pass over the rank's scenes, JAX's ``jax.vmap(prepare)``), and its macro
loop stays eager for every renderer, where one device's scenes run as
replays of their captured prepare and step (``engine/graphs.py``): the
step holds the ``views`` gather, a gloo collective cannot be captured into
a CUDA graph, and the capture of NCCL's cannot be checked on one card
(NCCL refuses two ranks on one card).

The JAX module's windowed tiers (its ``win_shapes`` branch) have no
counterpart: K1's list of live tiles does that job on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from skelsplat_tpu_torch.core.cameras import (Camera, flatten_scenes,
                                             stack_cameras)
from skelsplat_tpu_torch.core.gaussians import GaussianParams
from skelsplat_tpu_torch.engine.trainer import (MacroHistory, SceneTrainer,
                                                extent_from_centers,
                                                visit_order)

AXES = ("scenes", "views")


def choose_mesh(n_devices: int, nviews: int) -> tuple[int, int]:
    """Factor ``n_devices`` into (scenes_axis, views_axis): the views axis
    takes the largest divisor of ``nviews`` that also divides
    ``n_devices`` (8 ranks × 4 views → 2×4; 6 → 3×2; 5 → 5×1), so
    scenes_axis · views_axis == n_devices."""
    if n_devices <= 0 or nviews <= 0:
        raise ValueError(f"need positive counts, got {n_devices=} {nviews=}")
    views_axis = max(d for d in range(1, nviews + 1)
                     if nviews % d == 0 and n_devices % d == 0)
    return n_devices // views_axis, views_axis


def make_mesh(n_scenes: int, n_views: int, device_type: str = "cuda"):
    """A ``DeviceMesh`` of the process group's ranks, row-major over
    (scenes, views). Every rank calls it; the group must exist
    (``launch.init_from_env``) and hold exactly n_scenes · n_views ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel.launch.init_from_env)")
    n = dist.get_world_size()
    if n_scenes * n_views != n:
        raise ValueError(f"mesh {n_scenes}x{n_views} needs "
                         f"{n_scenes * n_views} ranks, have {n}")
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(n_scenes, n_views),
                      mesh_dim_names=AXES)


def batch_scene_records(records, cameras_batches):
    """Stack per-scene arrays into leading-batch ones for the scene axis:
    (initial (B,N,3), gt (B,N,3), p2d (B,V,N,2), cameras (B,V) Camera)."""
    initial = np.stack([np.asarray(r.pose_3d, np.float32) for r in records])
    gt = np.stack([np.asarray(r.pose_3d_gt, np.float32) for r in records])
    p2d = np.stack([np.asarray(r.poses_2d, np.float32)[..., :2]
                    for r in records])
    return initial, gt, p2d, stack_cameras(list(cameras_batches))


def scene_batch_extents(cams_b: Camera) -> np.ndarray:
    """(B,) per-scene spatial LR scale of a (B, V) camera batch, from its
    camera centres on the host."""
    centers = cams_b.cam_center.detach().cpu().numpy()
    return np.asarray([extent_from_centers(c) for c in centers], np.float32)


# int32 words between the starts of two tensors in a gather's buffer:
# 512 bytes, the caching allocator's own alignment. PyTorch's CUDA kernels
# pick vectorized or scalar loads by the alignment of their operands, and
# a reduction's rounding follows them (see ``prepare``): a gathered tensor
# lies where a fresh one would.
_ALIGN = 128


def _gather_blocks(tensors, dim: int, slot: int, n_slots: int, group,
                   contribute: bool = True):
    """Assemble tensors split in ``n_slots`` equal blocks along ``dim``
    over ``group``: each rank holds block ``slot``; every rank gets the
    whole tensors. Ranks with ``contribute`` false add zeros (they hold a
    copy of another rank's block). One all_reduce of the bits as int32."""
    shapes, offsets, total = [], [], 0
    for t in tensors:
        shape = list(t.shape)
        shape[dim] *= n_slots
        words = int(np.prod(shape)) * t.element_size() // 4
        shapes.append(shape)
        offsets.append(total)
        total += -(-words // _ALIGN) * _ALIGN
    flat = torch.zeros(total, dtype=torch.int32, device=tensors[0].device)
    out = []
    for t, shape, at in zip(tensors, shapes, offsets):
        n = int(np.prod(shape))
        full = flat[at:at + n * t.element_size() // 4].view(t.dtype) \
            .reshape(shape)
        if contribute:
            size = t.shape[dim]
            full.narrow(dim, slot * size, size).copy_(t)
        out.append(full)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return out


@dataclasses.dataclass(frozen=True)
class _LocalViews:
    """A rank's prepared views: ``cameras``, ``view_aux`` and
    ``poses_2d`` hold each of its scenes' local views one scene after
    another."""

    cameras: Camera
    view_aux: object
    poses_2d: torch.Tensor


class _Shard:
    """Where this rank sits in the mesh and what it holds of a batch."""

    def __init__(self, mesh, nviews: int):
        self.mesh = mesh
        self.n_scenes, self.n_views = mesh.shape
        self.scene, self.view = mesh.get_coordinate()
        if nviews % self.n_views:
            raise ValueError(f"{nviews} views do not split over a views "
                             f"axis of {self.n_views}")
        self.nviews = nviews
        self.v_loc = nviews // self.n_views
        self.views = slice(self.view * self.v_loc,
                           (self.view + 1) * self.v_loc)
        self.views_group = (mesh.get_group("views") if self.n_views > 1
                            else None)

    def scenes(self, B: int) -> slice:
        if B % self.n_scenes:
            raise ValueError(f"a batch of {B} scenes does not split over a "
                             f"scenes axis of {self.n_scenes}")
        b = B // self.n_scenes
        return slice(self.scene * b, (self.scene + 1) * b)


def multichip_train_step(mesh, trainer: SceneTrainer):
    """The sharded halves of a macro step on ``mesh``; returns
    ``(prepare, step)``:

      prepare(initial_b, poses_2d_b, cams_b, drop_b) → (params, state)
      step(state, k, params) → (losses_v, grads_v)

    ``prepare`` takes the whole batch (initial_b (B,N,3) numpy, poses_2d_b
    (B,V,N,2) and drop_b (B,V,N) tensors, cams_b a (B, V) Camera, all on
    this rank's device) and keeps this rank's scene and view slices: the
    parameters of its scenes (B/S, N, ·), each from its own initial pose,
    and the GT state of its views (made once per batch for all of its
    scenes' views, of which it keeps its own). ``step`` is ``SceneTrainer._run``'s
    ``view_grads``: it renders the local views (one K1 launch over all of
    them), gathers every view's loss and gradient over the ``views`` group
    and returns macro step ``k``'s visited views in visit order (``k``
    the loop's device step counter). Under
    general accumulation (A ≠ V) each rank renders all of its views and
    the visited ones are picked after the gather.
    """
    A = trainer.settings.accumulation_steps

    def prepare(initial_b, poses_2d_b, cams_b, drop_b):
        shard = _Shard(mesh, poses_2d_b.shape[1])
        sc, vw = shard.scenes(len(initial_b)), shard.views
        # the GT state of all of a scene's views, as one device makes it,
        # then this rank's rows of it: on the card, torch.sum over a row
        # rounds by the row's address (its vectorized loads), so a spec
        # made for a slice of the views can differ in the last place
        params, aux = trainer._prepare_batch(
            initial_b[sc], poses_2d_b[sc], cams_b.map(lambda x: x[sc]),
            drop_b[sc])
        n_loc = len(params.xyz)
        rows = (torch.arange(n_loc, device=poses_2d_b.device)[:, None]
                * shard.nviews
                + torch.arange(vw.start, vw.stop,
                               device=poses_2d_b.device)).reshape(-1)
        p2d = poses_2d_b[sc, vw]
        local = _LocalViews(
            flatten_scenes(cams_b.map(lambda x: x[sc, vw])),
            aux[rows] if trainer.renderer == "dense" else aux.take(rows),
            p2d.reshape((-1,) + tuple(p2d.shape[2:])))
        visits = (visit_order(trainer.n_macro, A, shard.nviews,
                              p2d.device) if A != shard.nviews else None)
        return params, (shard, local, visits)

    def step(state, k, params):
        shard, local, visits = state
        losses, grads = trainer._per_view_grads(
            params, local.cameras, local.view_aux, local.poses_2d,
            shard.v_loc)
        if shard.views_group is not None:
            losses, *fields = _gather_blocks(
                [losses, grads.xyz, grads.log_scales, grads.quats,
                 grads.opacity_logit], 1, shard.view, shard.n_views,
                shard.views_group)
            grads = GaussianParams(*fields)
        if visits is not None:
            at = visits.index_select(0, k.reshape(1)).reshape(-1)
            losses = losses.index_select(1, at)
            grads = grads.map(lambda g: g.index_select(1, at))
        return losses, grads

    return prepare, step


def multichip_programs(mesh, trainer: SceneTrainer):
    """``multichip_train_step(mesh, trainer)``: JAX caches its compiled
    programs per (trainer, mesh); here there is nothing to compile, so the
    closures are made afresh."""
    return multichip_train_step(mesh, trainer)


def multichip_optimize(mesh, trainer: SceneTrainer, initial_b, poses_2d_b,
                       cams_b: Camera, gt_b=None, drop_b=None,
                       checkpoint_iterations=(), checkpoint_fn=None):
    """Optimize B scenes on the mesh: every rank calls it with the whole
    batch and gets the whole result. B must split over the ``scenes``
    axis and each scene's V views over the ``views`` axis.

    initial_b (B,N,3), poses_2d_b (B,V,N,2+), gt_b (B,N,3) (zeros if
    absent) and drop_b (B,V,N) bool (no dropout if absent): numpy or host
    tensors; cams_b a (B, V) Camera, ideally on the CPU (the extents come
    from its camera centres on the host). As in ``optimize_scene``, each
    scene's initial pose gets its own seed-0 noise draw
    (``settings.std_dev_noise``). ``checkpoint_fn(iteration, params_b)``
    is called for each iteration of ``checkpoint_iterations`` (rounded
    down to a macro boundary) with the whole batch's parameters at that
    iteration, after the run: a rank keeps its checkpoints until the run
    ends, and one collective then assembles them with the results, the
    only one over the ``scenes`` axis.

    Returns (params with leading B, MacroHistory with losses (B,K,A),
    error/error_rel (B,K,N), stopped_at (B,)) on this rank's device, the
    contract of ``optimize_scene_batch``.
    """
    dev = trainer.device
    settings = trainer.settings
    initial_b = np.asarray(initial_b, dtype=np.float32)
    if settings.std_dev_noise > 0.0:
        initial_b = np.stack([
            x + np.random.default_rng(seed=0).normal(
                0.0, settings.std_dev_noise, x.shape)
            for x in initial_b]).astype(np.float32)
    poses_2d_b = np.ascontiguousarray(np.asarray(poses_2d_b)[..., :2],
                                      dtype=np.float32)
    B, nviews, n = poses_2d_b.shape[:3]
    gt_b = (np.zeros_like(initial_b) if gt_b is None
            else np.asarray(gt_b, dtype=np.float32))
    drop_b = (np.zeros((B, nviews, n), dtype=bool) if drop_b is None
              else np.asarray(drop_b, dtype=bool))
    extent_b = scene_batch_extents(cams_b)

    prepare, step = multichip_train_step(mesh, trainer)
    params, state = prepare(
        initial_b, torch.as_tensor(poses_2d_b, device=dev),
        cams_b.map(lambda x: x.to(dev)), torch.as_tensor(drop_b, device=dev))
    shard = state[0]
    sc = shard.scenes(B)
    saved = []
    params, hist = trainer._run(
        params, functools.partial(step, state), nviews,
        torch.as_tensor(gt_b[sc], device=dev),
        torch.as_tensor(extent_b[sc], device=dev), checkpoint_iterations,
        None if checkpoint_fn is None else (lambda it, p: saved.append((it, p))))

    local = [params.xyz, params.log_scales, params.quats,
             params.opacity_logit, hist.losses, hist.error, hist.error_rel,
             hist.stopped_at]
    local += [t for _, p in saved for t in
              (p.xyz, p.log_scales, p.quats, p.opacity_logit)]
    if shard.n_scenes > 1:
        # the ranks of a scenes row hold the same results: one of them
        # contributes
        local = _gather_blocks(local, 0, shard.scene, shard.n_scenes, None,
                               contribute=shard.view == 0)
    out = GaussianParams(*local[:4])
    for i, (it, _) in enumerate(saved):
        checkpoint_fn(it, GaussianParams(*local[8 + 4 * i:12 + 4 * i]))
    return out, MacroHistory(losses=local[4], error=local[5],
                             error_rel=local[6], stopped_at=local[7])
