"""Per-scene optimization engine (counterpart of
``skelsplat_tpu/engine/trainer.py``).

The reference renders one view per iteration round-robin and steps Adam
every ``accumulation_steps`` iterations with xyz grad = mean of the per-view
grads and scale/rot/opacity grads from the last rendered view only. Since
the parameters are constant between optimizer steps, one macro step is:
render all visited views at the current parameters, combine gradients,
step. Here a macro step is a batch over the visited views (one preprocess
over (A, N), one kernel launch for all A views), and the scene is a loop
over macro steps that never waits on the device: every decision (early
stop, freezing after it) is a tensor select, and the step reads its index
from a device counter.

On a GPU the scene is one device program, as JAX's jitted scene is, for
every renderer: the macro step is captured once as a CUDA graph
(``engine/graphs.py``) and replayed ``n_macro`` times;
``SceneTrainer(eager=True)`` runs the same step op by op instead, for
comparisons (the counterpart of ``jax.disable_jit()``). On the CPU the
loop is eager.

Early stopping is exact for every (nviews, accumulation_steps): the
reference's 8-loss window check runs against a rolling history, and a
mid-macro stop steps with the reference's mixed fresh/stale gradients.

``optimize_scene_batch`` runs B independent scenes of one (W, H, V) shape
at once: each macro step is one preprocess and one kernel launch over the
B·A visited views and one backward, and compose, Adam and the early-stop
window are per scene. The composition functions take leading scene axes
on every carried tensor, so one scene and a batch run the same code.
``optimize_scene_chain`` runs G scenes one after another with the
early-stop window carried between them, each scene bitwise its serial run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from skelsplat_tpu_torch import losses as loss_registry
from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.core.cameras import Camera, flatten_scenes
from skelsplat_tpu_torch.core.gaussians import (PARAM_FIELDS, GaussianParams,
                                                SkeletonModel, init_params)
from skelsplat_tpu_torch.engine import graphs
from skelsplat_tpu_torch.engine.optim import AdamGroups, OptConfig
from skelsplat_tpu_torch.ops import cuda_raster
from skelsplat_tpu_torch.ops import heatmaps as hm
from skelsplat_tpu_torch.ops import rasterizer
from skelsplat_tpu_torch.ops.fused import FUSED_LOSSES, make_fused_view_loss
from skelsplat_tpu_torch.ops.similarity import confidence_weighted_mean
from skelsplat_tpu_torch.utils import put_trees, tree_leaves, tree_map

REPEAT_TOL = 1e-6  # OptEarlyStopping repeat_tolerance
RENDERERS = ("auto", "cuda", "fused", "dense")


def stop_offset(hist8, cur, tol):
    """First inner-iteration offset m ∈ {1..A} at which the reference's
    8-loss window check fires during this macro step.

    ``hist8`` (…,8) holds the 8 most recent per-iteration losses
    (+inf-padded while the history is short); ``cur`` (…,A) this macro's A
    per-view losses in visit order; leading scene axes give each scene its
    own window. After m of them the check compares full[m+4:m+8] with
    full[m:m+4] of the concatenated (8+A,) vector; a window touching a pad
    entry compares false (|inf−x| = inf, |inf−inf| = nan).

    Returns (stop_now, m_star, new_hist8) with m_star = A when no stop and
    new_hist8 the 8 losses ending at the stop offset.
    """
    A = cur.shape[-1]
    full = torch.cat([hist8, cur], dim=-1)
    conds = torch.stack([
        torch.all(torch.abs(full[..., m:m + 4] - full[..., m + 4:m + 8]) < tol,
                  dim=-1)
        for m in range(1, A + 1)], dim=-1)
    stop_now = torch.any(conds, dim=-1)
    m_star = torch.where(stop_now,
                         torch.argmax(conds.to(torch.uint8), dim=-1) + 1,
                         torch.full((), A, dtype=torch.int64,
                                    device=cur.device))
    new_hist8 = torch.take_along_dim(
        full, m_star[..., None] + torch.arange(8, device=full.device), dim=-1)
    return stop_now, m_star, new_hist8


def _telemetry_norms(pred, pose_3d_gt):
    """Absolute and pelvis-relative per-joint errors of (…,N,3) joints."""
    err = torch.linalg.vector_norm(pred - pose_3d_gt, dim=-1)
    err_rel = torch.linalg.vector_norm(
        (pred - pred[..., :1, :]) - (pose_3d_gt - pose_3d_gt[..., :1, :]),
        dim=-1)
    return err, err_rel


def _last_visit_rows(acc_gx, grads_xyz, idxs, m_star):
    """The reference's sequential ``accumulated_grads[view] = grad`` writes
    of visit offsets j < m_star (the last visit of a view wins; other rows
    keep their stale value), as one gather. ``acc_gx`` (…,V,N,3),
    ``grads_xyz`` (…,A,N,3), ``m_star`` (…) per scene; ``idxs`` (A,) the
    visit order, the same in every scene."""
    A, nv = idxs.shape[0], acc_gx.shape[-3]
    offs = torch.arange(A, device=idxs.device)
    visits = ((idxs[:, None] == torch.arange(nv, device=idxs.device)[None, :])
              & (offs[:, None] < m_star[..., None, None]))
    j_last = torch.amax(torch.where(visits, offs[:, None],
                                    torch.full_like(visits, -1, dtype=offs.dtype)),
                        dim=-2)
    rows = torch.take_along_dim(grads_xyz,
                                torch.clamp(j_last, min=0)[..., None, None],
                                dim=-3)
    return torch.where((j_last >= 0)[..., None, None], rows, acc_gx)


def visit_order(K: int, A: int, nviews: int, device) -> torch.Tensor:
    """(K, A) int64: the reference visits views (k·A + j) mod V during
    macro step k, in every scene."""
    ks = torch.arange(K, dtype=torch.int64, device=device)
    return (ks[:, None] * A + torch.arange(A, device=device)) % nviews


def view_fusion_fn(view_fusion: str):
    """The xyz fusion over the view axis (dim −3 of (…,V,N,3)): "mean", the
    reference's plain mean, or "confidence_weighted", each view weighted
    by its gradient's agreement with the others (``ops/similarity.py``)."""
    if view_fusion == "confidence_weighted":
        return confidence_weighted_mean
    if view_fusion == "mean":
        return lambda g: torch.mean(g, dim=-3)
    raise ValueError(f"unknown view_fusion {view_fusion!r}")


def compose_macro(adam: AdamGroups, V_accum: int, use_stop: bool,
                  general: bool, carry, k, losses_v, grads_v: GaussianParams,
                  idxs, pose_3d_gt, spatial_lr_scale,
                  view_fusion: str = "mean", lean: bool = False):
    """One macro step's gradient composition + Adam update + telemetry.

    ``carry`` = (params, opt_state, [hist8,] stopped[, acc_gx]);
    ``losses_v``/``grads_v`` hold the A visited views' losses/grads in visit
    order (axis A after the scene axes), ``idxs`` their view indices, ``k``
    the 0-based macro index as a device tensor. Every carried tensor, the
    losses, grads, ``pose_3d_gt`` and ``spatial_lr_scale`` may carry leading
    scene axes: each scene composes, steps and stops on its own. Returns
    (new_carry, rec) with rec = (losses_v, err, err_rel, stop_mark), or
    (losses_v, stop_mark) when ``lean``. ``view_fusion`` picks the xyz
    fusion (``view_fusion_fn``); the other groups step on the last view.
    """
    fuse_xyz = view_fusion_fn(view_fusion)
    lead = tuple(losses_v.shape[:-1])
    dev = losses_v.device
    acc_gx = None
    if general or use_stop:
        carry, acc_gx = carry[:-1], carry[-1]
    if use_stop:
        params, opt_state, hist8, stopped = carry
        stop_now, m_star, hist8_new = stop_offset(hist8, losses_v, REPEAT_TOL)
        # after a stop the reference leaves its loop: the history freezes
        hist8 = torch.where(stopped[..., None], hist8, hist8_new)
    else:
        params, opt_state, stopped = carry
        stop_now = torch.zeros(lead, dtype=torch.bool, device=dev)
        m_star = torch.full(lead, V_accum, dtype=torch.int64, device=dev)
    if general:
        acc_gx = _last_visit_rows(acc_gx, grads_v.xyz, idxs, m_star)
        g_xyz = fuse_xyz(acc_gx)
    elif use_stop:
        row_new = (torch.arange(V_accum, device=dev)[:, None, None]
                   < m_star[..., None, None, None])
        acc_gx = torch.where(row_new, grads_v.xyz, acc_gx)
        g_xyz = fuse_xyz(acc_gx)
    else:
        g_xyz = fuse_xyz(grads_v.xyz)
    # the last visited view (A−1 without a stop), as an index tensor: a
    # Python int would wait for the device
    oidx = (m_star - 1).reshape(lead + (1, 1, 1))
    grads = GaussianParams(g_xyz, *(
        torch.take_along_dim(g, oidx, dim=len(lead)).squeeze(len(lead))
        for g in (grads_v.log_scales, grads_v.quats, grads_v.opacity_logit)))
    iteration = k * V_accum + m_star

    new_params, new_opt = adam.step(params, grads, opt_state, iteration,
                                    spatial_lr_scale)
    apply = torch.logical_not(stopped)
    apply_f = apply[..., None, None]   # against (…,N,·) fields

    def keep(a, b):
        return torch.where(apply_f, a, b)

    params2 = new_params.map(keep, params)
    opt2 = dataclasses.replace(
        new_opt, m=new_opt.m.map(keep, opt_state.m),
        v=new_opt.v.map(keep, opt_state.v),
        t=torch.where(apply, new_opt.t, opt_state.t))
    stopped2 = stopped | (stop_now & apply)

    stop_mark = torch.where(stop_now & apply, iteration,
                            torch.zeros_like(iteration))
    if lean:
        rec = (losses_v, stop_mark)
    else:
        err, err_rel = _telemetry_norms(params2.xyz, pose_3d_gt)
        rec = (losses_v, err, err_rel, stop_mark)
    new_carry = ((params2, opt2, hist8, stopped2) if use_stop
                 else (params2, opt2, stopped2))
    if general or use_stop:
        new_carry = new_carry + (acc_gx,)
    return new_carry, rec


def init_macro_carry(params, opt_state, nviews: int, use_stop: bool,
                     general: bool, hist8_init=None):
    """The carry matching compose_macro's layout (accumulated_grads starts
    at zero and persists across macro steps), with the scene axes of
    ``params``. With ``use_stop``, ``hist8_init`` (a tensor: the previous
    scene's ``MacroHistory.hist8``) seeds the early-stop window, which
    starts at +inf otherwise."""
    dev = params.xyz.device
    lead = tuple(params.xyz.shape[:-2])
    acc0 = ((torch.zeros(lead + (nviews,) + tuple(params.xyz.shape[-2:]),
                         dtype=torch.float32, device=dev),)
            if (general or use_stop) else ())
    stopped = torch.zeros(lead, dtype=torch.bool, device=dev)
    if use_stop:
        hist8 = (torch.full(lead + (8,), float("inf"), dtype=torch.float32,
                            device=dev) if hist8_init is None
                 else hist8_init.to(dev, torch.float32))
        return (params, opt_state, hist8, stopped) + acc0
    return (params, opt_state, stopped) + acc0


def extent_from_centers(centers) -> float:
    """The per-scene spatial LR scale from (V, 3) camera centers: 1.1 × the
    max distance from their centroid."""
    centers = np.asarray(centers, dtype=np.float64)
    center = centers.mean(axis=0, keepdims=True)
    diagonal = np.linalg.norm(centers - center, axis=1).max()
    return float(diagonal * 1.1)


def cameras_extent(cameras: Camera) -> float:
    """``extent_from_centers`` of a camera batch's centers (one host copy
    of them when they lie on the card)."""
    return extent_from_centers(cameras.cam_center.detach().cpu().numpy())


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """The ``training`` config group."""

    loss_function: str = "l2_gaussian"
    lambda_loss_function: float = 0.05
    consistency_loss: str = "3D_length_consistency"
    lambda_consistency: float = 1e-5
    early_stopping: str = "no_stopping"   # opt_early_stopping | no_stopping
    accumulation_steps: int = 4
    dropout: bool = False
    std_dev_noise: float = 0.0  # σ (mm) of the noise added to the initial pose
    view_fusion: str = "mean"   # xyz fusion: mean | confidence_weighted


@dataclasses.dataclass(frozen=True)
class MacroHistory:
    """Per-macro-step telemetry, on the device (a batch of scenes adds a
    leading B to every field)."""

    losses: torch.Tensor      # (K, A) per-visit total losses
    error: torch.Tensor       # (K, N) per-joint absolute error ‖pred−gt‖
    error_rel: torch.Tensor   # (K, N) root-aligned error
    stopped_at: torch.Tensor  # int64, iteration of the early stop (0 = none)
    # final loss window (early stopping): seeds the next scene's window
    hist8: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class LoopState:
    """The macro loop's state on the device. A macro step writes each
    tensor in place, so a captured step finds it where it left it."""

    carry: tuple                    # compose_macro's carry
    losses: torch.Tensor            # (…, K or 1, A)
    error: torch.Tensor | None      # (…, K, N); None when lean
    error_rel: torch.Tensor | None
    stop_max: torch.Tensor          # (…,) int64 stop iteration, 0 = none
    step: torch.Tensor              # () int64: the next macro step's index


def _check_finite(k: int, A: int, losses_v, grads_v: GaussianParams,
                  params: GaussianParams):
    """Debug mode: raise ``FloatingPointError`` naming macro step ``k``
    (0-based, ``A`` iterations a step) if its losses, gradients or updated
    parameters hold a NaN or an infinity. One host sync."""
    named = [("losses", losses_v)]
    named += [(f"{f} gradient", getattr(grads_v, f)) for f in PARAM_FIELDS]
    named += [(f"{f} parameter", getattr(params, f)) for f in PARAM_FIELDS]
    finite = torch.stack([torch.isfinite(t).all() for _, t in named]).tolist()
    bad = [name for (name, _), ok in zip(named, finite) if not ok]
    if bad:
        raise FloatingPointError(
            f"non-finite {', '.join(bad)} at macro step {k} (iterations "
            f"{k * A + 1}-{(k + 1) * A})")


class SceneTrainer:
    """Runs the full per-scene optimization on one device.

    ``renderer``: "cuda" (the hand-written kernel; its plain PyTorch
    version on the CPU), "fused" (the row-chunk autograd stream), "dense"
    (full images through the autograd oracle and the loss registry) or
    "auto": the kernel for the masked heatmap losses it implements, dense
    for every other loss (the soft-argmax and plain-mean losses).
    ``debug`` checks every macro step's losses, gradients and parameters
    for NaN and infinity, at one host sync a step (``_check_finite``).

    On a GPU every renderer's scenes run as replays of a captured macro
    step, one graph per program shape, cached in ``graphs``; ``eager``
    runs the step op by op instead (the counterpart of
    ``jax.disable_jit()``, for tests and comparisons: no config key sets
    it). The mesh path (``parallel/mesh.py``) always runs eagerly.
    """

    def __init__(self, model: SkeletonModel, opt: OptConfig,
                 settings: TrainSettings, width: int, height: int,
                 antialiasing: bool = False, renderer: str = "auto",
                 device="cuda", debug: bool = False, eager: bool = False):
        self.device = resolve_device(device)
        self.eager = eager
        self.graphs: dict[tuple, graphs.StepGraph] = {}
        self.model = model
        self.opt = opt
        self.settings = settings
        self.W, self.H = int(width), int(height)
        self.antialiasing = antialiasing
        if settings.accumulation_steps <= 0:
            raise ValueError("accumulation_steps must be positive")
        if renderer not in RENDERERS:
            raise ValueError(f"renderer must be one of {RENDERERS}, "
                             f"got {renderer!r}")
        view_fusion_fn(settings.view_fusion)
        if renderer == "auto":
            renderer = ("cuda" if settings.loss_function in FUSED_LOSSES
                        else "dense")
        if renderer != "dense" and settings.loss_function not in FUSED_LOSSES:
            raise ValueError(f"renderer {renderer!r} does not implement "
                             f"{settings.loss_function!r}")
        self.renderer = renderer
        self.debug = debug
        self.n_macro = opt.iterations // settings.accumulation_steps
        self.adam = AdamGroups(opt)
        if renderer == "cuda":
            self._view_loss = cuda_raster.make_cuda_view_loss(
                model, settings, self.W, self.H, antialiasing)
        elif renderer == "fused":
            self._view_loss = make_fused_view_loss(
                model, settings, self.W, self.H, antialiasing)
        else:
            self._view_loss = self._view_loss_dense

    def _view_loss_dense(self, params, cameras, gt_heatmaps, poses_2d):
        """(A,) losses: render → clamp → registry loss + consistency."""
        out = rasterizer.render(params, cameras, self.W, self.H,
                                antialiasing=self.antialiasing)
        dev = self.device
        ys = torch.arange(self.H, dtype=torch.float32, device=dev)[:, None]
        xs = torch.arange(self.W, dtype=torch.float32, device=dev)
        inside = ((ys < cameras.height[:, None, None, None])
                  & (xs < cameras.width[:, None, None, None]))
        render = torch.where(inside, out["render"],
                             torch.zeros_like(out["render"]))
        loss_fn = loss_registry.losses[self.settings.loss_function]
        main, _ = loss_fn(render, gt_heatmaps, poses_2d,
                          self.settings.lambda_loss_function,
                          reduction="mean",
                          domain=(cameras.width, cameras.height))
        cons_fn = loss_registry.consistency_losses[
            self.settings.consistency_loss]
        cons = cons_fn(params.xyz, self.model.scene_type, reduction="mean")
        return main + cons * self.settings.lambda_consistency

    def _prepare(self, initial_pose, poses_2d, cameras, drop_mask):
        """Parameters (from the (N,3) ``initial_pose``, numpy or a device
        tensor) and the GT state from the INITIAL covariance, once per
        scene."""
        m = self.model
        params = init_params(initial_pose, m.scene_type, m.scaling,
                             m.scaling_modifier, device=self.device)
        spec = hm.heatmap_spec(params.xyz, params.covariance(), poses_2d,
                               cameras, self.W, self.H, drop_mask=drop_mask)
        if self.renderer == "dense":
            view_aux = hm.eval_heatmaps(spec, self.W, self.H)
        elif self.renderer == "cuda":
            view_aux = cuda_raster.view_profiles(spec, self.W, self.H)
        else:
            view_aux = spec
        return params, view_aux

    def _prepare_batch(self, initial_b, poses_2d_b, cameras_b, drop_b):
        """``_prepare`` of each scene (its parameters and its GT state from
        its own initial covariance), once per batch: parameters stacked
        (B,N,·), view aux concatenated over the B·V views (scene b's view
        v at b·V + v)."""
        per = [self._prepare(initial_b[b], poses_2d_b[b], cameras_b.take(b),
                             drop_b[b]) for b in range(len(initial_b))]
        params = per[0][0].map(lambda *xs: torch.stack(xs),
                               *(p for p, _ in per[1:]))
        auxes = [a for _, a in per]
        if isinstance(auxes[0], torch.Tensor):    # dense GT heatmaps
            return params, torch.cat(auxes)
        return params, type(auxes[0])(*map(torch.cat, zip(*auxes)))

    def _per_view_grads(self, params, cameras, view_aux, poses_2d, A):
        """(losses (…,A), grads (…,A,N,·)) of the visited views of a scene,
        or of a batch of scenes (``params`` with leading scene axes;
        ``cameras``, ``view_aux`` and ``poses_2d`` then hold each scene's A
        visited views, one scene after another): one forward over every
        visited view with per-view parameter copies, one backward."""
        lead = tuple(params.xyz.shape[:-2])

        def copies(x):
            own = tuple(x.shape[len(lead):])
            return (x.detach().unsqueeze(len(lead))
                    .expand(lead + (A,) + own).clone()
                    .reshape((-1,) + own).requires_grad_(True))

        p = params.map(copies)
        with torch.enable_grad():
            losses = self._view_loss(p, cameras, view_aux, poses_2d)
            grads = torch.autograd.grad(
                losses.sum(), [p.xyz, p.log_scales, p.quats, p.opacity_logit])
        return (losses.detach().reshape(lead + (A,)),
                GaussianParams(*(g.reshape(lead + (A,) + tuple(g.shape[1:]))
                                 for g in grads)))


    def host_inputs(self, initial_pose, poses_2d, cameras: Camera,
                    pose_3d_gt=None, drop_mask=None, drop_generator=None):
        """Host-side inputs of one scene, everything ``optimize_scene``
        needs before the device transfer: dtypes, the noise injection
        (``settings.std_dev_noise``, from a seed-0 numpy generator made
        anew for every scene), the dropout mask (used when
        ``settings.dropout``: the given (V,N) bool ``drop_mask``, else one
        drawn from ``drop_generator`` by ``heatmaps.dropout_masks``) and
        the scene extent (the spatial LR scale) from the camera centres.

        Returns JAX's tuple (initial_pose, poses_2d, cameras, pose_3d_gt,
        drop_mask, extent): numpy, with ``cameras`` as given (pass them on
        the CPU, as the driver does, and no device is involved) and a mask
        drawn from a generator on the generator's device. A sweep passes a
        list of these through one ``utils.put_trees`` (one packed copy for
        a group of scenes) and hands each back via ``optimize_scene(...,
        inputs=...)`` or ``optimize_scene_chain``."""
        initial_pose = np.asarray(initial_pose, dtype=np.float32)
        if self.settings.std_dev_noise > 0.0:
            rng = np.random.default_rng(seed=0)
            initial_pose = (initial_pose + rng.normal(
                0.0, self.settings.std_dev_noise, initial_pose.shape)
            ).astype(np.float32)
        if pose_3d_gt is None:
            pose_3d_gt = np.zeros_like(initial_pose)
        poses_2d = np.ascontiguousarray(np.asarray(poses_2d)[..., :2],
                                        dtype=np.float32)
        nviews, n = poses_2d.shape[0], poses_2d.shape[1]
        if self.settings.dropout and drop_mask is not None:
            drop_mask = np.asarray(drop_mask, dtype=bool)
        elif self.settings.dropout and drop_generator is not None:
            drop_mask = hm.dropout_masks(drop_generator, nviews, n)
        else:
            drop_mask = np.zeros((nviews, n), dtype=bool)
        extent = np.asarray(cameras_extent(cameras), np.float32)
        return (initial_pose, poses_2d, cameras,
                np.asarray(pose_3d_gt, dtype=np.float32), drop_mask, extent)

    def optimize_scene(self, initial_pose, poses_2d, cameras: Camera = None,
                       pose_3d_gt=None, drop_mask=None,
                       checkpoint_iterations=(), checkpoint_fn=None,
                       hist8_init=None, lean: bool = False,
                       drop_generator=None, inputs=None):
        """Run the full optimization of one scene.

        initial_pose (N,3); poses_2d (V,N,2+); cameras a batched Camera
        (on the CPU, or already on the device); pose_3d_gt (N,3) for
        telemetry (zeros if absent). Returns (params, MacroHistory), all
        on the device: nothing in the loop waits for it. ``lean`` keeps
        only the last telemetry row (K=1).

        ``inputs``: a ``host_inputs`` tuple already on the device (one
        element of ``utils.put_trees``' result); the data arguments are
        then ignored. Without it the scene's inputs go over in one packed
        copy.

        ``checkpoint_fn(iteration, params)`` is called with a device copy
        of the parameters after each macro step that ends an iteration of
        ``checkpoint_iterations``, each rounded down to a macro boundary
        (the iteration passed is the rounded one). ``hist8_init`` seeds
        the early-stop window with the previous scene's
        ``MacroHistory.hist8``: the reference's stopper is made once per
        sweep, so its 8-loss window spans scene boundaries.
        ``drop_generator`` draws the dropout mask where ``drop_mask`` is
        not given (``host_inputs``).
        """
        if inputs is None:
            inputs = put_trees([self.host_inputs(
                initial_pose, poses_2d, cameras, pose_3d_gt, drop_mask,
                drop_generator)], self.device)[0]
        return self._optimize_inputs(inputs, checkpoint_iterations,
                                     checkpoint_fn, hist8_init, lean)

    def _optimize_inputs(self, inputs, checkpoint_iterations=(),
                         checkpoint_fn=None, hist8_init=None,
                         lean: bool = False, keep: bool = True):
        """``optimize_scene`` of device ``inputs``. With ``keep`` false
        the results of a captured run are the graph's own buffers, valid
        until its next scene (``optimize_scene_chain`` copies them)."""
        init, poses_2d, cameras, pose_3d_gt, drop_mask, extent = inputs
        params, view_aux = self._prepare(init, poses_2d, cameras, drop_mask)
        return self._run_scenes(params, cameras, view_aux, poses_2d,
                                pose_3d_gt, extent, 1, poses_2d.shape[0],
                                checkpoint_iterations, checkpoint_fn,
                                hist8_init, lean, keep)

    def optimize_scene_chain(self, host_inputs_list, hist8_init=None,
                             lean: bool = False):
        """Run G scenes of one (V, N) shape one after another (counterpart
        of JAX's ``optimize_scene_chain``, a ``lax.scan`` of the scene
        program over the group): the group's inputs go over in one packed
        copy, and the early-stop window (``hist8``) passes from scene to
        scene on the device, so each scene's results are bitwise those of
        ``optimize_scene`` in a loop with the window carried. On the card
        each scene is ``n_macro`` replays of the cached step graph, its
        results copied into the group's stacked outputs before the next
        scene is loaded; on the CPU it is the eager loop.

        ``host_inputs_list``: ``host_inputs`` tuples. Returns (params,
        MacroHistory) with a leading G axis on every field but ``hist8``,
        the final window (seed the next group's call with it; None without
        early stopping); ``stopped_at`` is (G,). ``lean`` keeps only each
        scene's last telemetry row (K=1).
        """
        use_stop = self.settings.early_stopping == "opt_early_stopping"
        hist8 = hist8_init if use_stop else None
        group = put_trees(list(host_inputs_list), self.device)
        out = None
        for g, inputs in enumerate(group):
            params, history = self._optimize_inputs(
                inputs, hist8_init=hist8, lean=lean, keep=False)
            res = (params, dataclasses.replace(history, hist8=None))
            if out is None:
                out = tree_map(lambda x: x.new_empty((len(group),)
                                                     + tuple(x.shape)), res)
            tree_map(lambda o, x, g=g: o[g].copy_(x), out, res)
            hist8 = history.hist8
        params_g, history_g = out
        return params_g, dataclasses.replace(
            history_g, hist8=None if hist8 is None else hist8.clone())

    def optimize_scene_batch(self, initial_b, poses_2d_b, cameras_b: Camera,
                             pose_3d_gt_b=None, lean: bool = False):
        """Run B independent scenes of this trainer's (W, H) and one view
        count at once: every macro step is one preprocess, one kernel launch
        and one backward over the B·A visited views, and each scene
        composes its gradients, steps Adam (with its own extent as the xyz
        LR scale) and, under early stopping, stops and freezes on its own
        8-loss window, which starts at +inf. Per scene the results are
        those of ``optimize_scene`` without checkpoints, noise or dropout
        (the batched sweep's conditions).

        initial_b (B,N,3), poses_2d_b (B,V,N,2+), pose_3d_gt_b (B,N,3)
        (zeros if absent): numpy or host tensors; cameras_b a Camera with
        leading (B, V) axes (``stack_cameras`` of the scenes' Cameras),
        ideally on the CPU: the extents come from its camera centres on the
        host. The batch's inputs go over in one packed copy. Returns
        (params with leading B, MacroHistory with losses (B,K,A),
        error/error_rel (B,K,N), stopped_at (B,)), on the device; ``lean``
        keeps only the last telemetry row (K=1).
        """
        initial_b = np.asarray(initial_b, dtype=np.float32)
        poses_2d_b = np.ascontiguousarray(np.asarray(poses_2d_b)[..., :2],
                                          dtype=np.float32)
        B, nviews, n = poses_2d_b.shape[:3]
        pose_3d_gt_b = (np.zeros_like(initial_b) if pose_3d_gt_b is None
                        else np.asarray(pose_3d_gt_b, dtype=np.float32))
        centers = cameras_b.cam_center.detach().cpu().numpy()
        extent = np.asarray([extent_from_centers(c) for c in centers],
                            np.float32)
        drop_b = np.zeros((B, nviews, n), dtype=bool)
        initial_b, poses_2d_b, cameras_b, pose_3d_gt_b, drop_b, extent = \
            put_trees([(initial_b, poses_2d_b, cameras_b, pose_3d_gt_b,
                        drop_b, extent)], self.device)[0]
        params, view_aux = self._prepare_batch(initial_b, poses_2d_b,
                                               cameras_b, drop_b)
        return self._run_scenes(
            params, flatten_scenes(cameras_b), view_aux,
            poses_2d_b.reshape((B * nviews,) + (n, 2)), pose_3d_gt_b, extent,
            B, nviews, lean=lean)

    def _visited_grads(self, cameras, view_aux, poses_2d, n_scenes: int,
                       nviews: int):
        """``view_grads`` of ``_run`` for scenes whose views all live here:
        ``cameras``, ``view_aux`` and ``poses_2d`` hold every scene's
        ``nviews`` views one scene after another, and each macro step
        renders the A visited views of every scene, in visit order."""
        A = self.settings.accumulation_steps
        if A == nviews:
            return lambda k, params: self._per_view_grads(
                params, cameras, view_aux, poses_2d, A)
        idx_all = visit_order(self.n_macro, A, nviews, self.device)
        # row k indexes macro step k's visits in the scenes' flat views
        flat_all = (torch.arange(n_scenes, device=self.device)[None, :, None]
                    * nviews + idx_all[:, None, :]).reshape(self.n_macro,
                                                            n_scenes * A)

        def grads(k, params):
            flat = flat_all.index_select(0, k.reshape(1)).reshape(-1)
            aux_k = (view_aux[flat] if self.renderer == "dense"
                     else view_aux.take(flat))
            return self._per_view_grads(params, cameras.take(flat), aux_k,
                                        poses_2d[flat], A)
        return grads

    @property
    def captures(self) -> bool:
        """Whether scenes run as replays of captured macro steps: on a GPU,
        for every renderer, unless the trainer was made with
        ``eager=True``. Nothing else decides it: a step that cannot be
        captured raises."""
        return self.device.type == "cuda" and not self.eager

    def _loop_state(self, params, nviews: int, hist8_init, lean: bool):
        """The macro loop's initial state, every tensor its own buffer
        (the steps write into them in place)."""
        dev = self.device
        lead = tuple(params.xyz.shape[:-2])
        A, K = self.settings.accumulation_steps, self.n_macro
        use_stop = self.settings.early_stopping == "opt_early_stopping"
        carry = init_macro_carry(params, self.adam.init(params), nviews,
                                 use_stop, A != nviews, hist8_init)
        n = params.xyz.shape[-2]

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(lead + shape, dtype=dtype, device=dev)

        return LoopState(
            carry=tree_map(torch.clone, carry),
            losses=zeros((1 if lean else K, A)),
            error=None if lean else zeros((K, n)),
            error_rel=None if lean else zeros((K, n)),
            stop_max=zeros((), torch.int64),
            step=torch.zeros((), dtype=torch.int64, device=dev))

    def _step_fn(self, view_grads, nviews: int, pose_3d_gt, extent,
                 lean: bool):
        """One macro step as ``step(state) -> (losses_v, grads_v)``: the
        visited views' losses and gradients at the state's parameters
        (``view_grads(k, params)`` with ``k`` the device step counter),
        then compose + Adam + the early-stop window, all written into
        ``state`` in place, and the counter advanced. The step index is
        read on the device, never from Python, so a captured step serves
        every step."""
        A = self.settings.accumulation_steps
        use_stop = self.settings.early_stopping == "opt_early_stopping"
        general = A != nviews
        idx_all = visit_order(self.n_macro, A, nviews, self.device)
        view_fusion = self.settings.view_fusion

        def step(st: LoopState):
            k = st.step
            at = k.reshape(1)
            axis = st.stop_max.dim()     # the history's step axis
            losses_v, grads_v = view_grads(k, st.carry[0])
            carry, rec = compose_macro(
                self.adam, A, use_stop, general, st.carry, k, losses_v,
                grads_v, idx_all.index_select(0, at).reshape(-1),
                pose_3d_gt, extent, view_fusion, lean=lean)
            for dst, src in zip(tree_leaves(st.carry), tree_leaves(carry),
                                strict=True):
                dst.copy_(src)
            if lean:
                st.losses.select(axis, 0).copy_(rec[0])
            else:
                st.losses.index_copy_(axis, at, rec[0].unsqueeze(axis))
                st.error.index_copy_(axis, at, rec[1].unsqueeze(axis))
                st.error_rel.index_copy_(axis, at, rec[2].unsqueeze(axis))
            st.stop_max.copy_(torch.maximum(st.stop_max, rec[-1]))
            st.step.add_(1)
            return losses_v, grads_v
        return step

    def _run_scenes(self, params, cameras, view_aux, poses_2d, pose_3d_gt,
                    extent, n_scenes: int, nviews: int,
                    checkpoint_iterations=(), checkpoint_fn=None,
                    hist8_init=None, lean: bool = False, keep: bool = True):
        """The macro loop of prepared scenes whose views all live here
        (``_visited_grads``): the eager ``_run``, or, where the trainer
        ``captures``, replays of the step graph of this program shape,
        made on first use and cached. ``keep`` false returns the graph's
        own result buffers instead of copies."""
        if not self.captures:
            return self._run(
                params, self._visited_grads(cameras, view_aux, poses_2d,
                                            n_scenes, nviews),
                nviews, pose_3d_gt, extent, checkpoint_iterations,
                checkpoint_fn, hist8_init, lean)
        state = self._loop_state(params, nviews, hist8_init, lean)
        inputs = (cameras, view_aux, poses_2d, pose_3d_gt, extent)
        key = (tuple(params.xyz.shape[:-2]), nviews,
               self.settings.accumulation_steps, params.xyz.shape[-2],
               self.W, self.H, lean, self.settings.early_stopping,
               self.settings.accumulation_steps != nviews, self.renderer,
               self.settings.view_fusion)
        graph = self.graphs.get(key)
        if graph is None:
            def make_step(inp, st):
                cams, aux, p2d, gt, ext = inp
                step = self._step_fn(
                    self._visited_grads(cams, aux, p2d, n_scenes, nviews),
                    nviews, gt, ext, lean)
                return lambda: step(st)
            graph = self.graphs[key] = graphs.StepGraph(inputs, state,
                                                        make_step)
        graph.load(inputs, state)
        out = self._loop(graph.step, graph.state, graph.inputs[3],
                         checkpoint_iterations, checkpoint_fn, lean)
        return tree_map(torch.clone, out) if keep else out

    def _run(self, params, view_grads, nviews: int, pose_3d_gt, extent,
             checkpoint_iterations=(), checkpoint_fn=None, hist8_init=None,
             lean: bool = False):
        """The eager macro loop over prepared state, for one scene or a
        batch: ``params``, ``pose_3d_gt`` and ``extent`` carry the scene
        axes (none for one scene, (B,) for a batch). ``view_grads(k,
        params)`` gives macro step ``k``'s (losses (…,A), grads (…,A,N,·))
        of the visited views in visit order, ``k`` a device int64 scalar
        (``_visited_grads``, or the mesh's gather in
        ``parallel/mesh.py``); ``nviews`` is each scene's view count."""
        state = self._loop_state(params, nviews, hist8_init, lean)
        step = self._step_fn(view_grads, nviews, pose_3d_gt, extent, lean)
        return self._loop(lambda: step(state), state, pose_3d_gt,
                          checkpoint_iterations, checkpoint_fn, lean)

    def _loop(self, run_step, st: LoopState, pose_3d_gt,
              checkpoint_iterations, checkpoint_fn, lean: bool):
        """``n_macro`` calls of ``run_step``, with the debug check and the
        checkpoints between them; returns (params, MacroHistory) of the
        state's tensors."""
        A, K = self.settings.accumulation_steps, self.n_macro
        saves = {min(max(it // A, 0), K) for it in checkpoint_iterations}
        saves.discard(0)
        for k in range(K):
            losses_v, grads_v = run_step()
            if self.debug:
                _check_finite(k, A, losses_v, grads_v, st.carry[0])
            if checkpoint_fn is not None and k + 1 in saves:
                checkpoint_fn((k + 1) * A, st.carry[0].map(torch.clone))

        params = st.carry[0]
        err_h, err_rel_h = st.error, st.error_rel
        if lean:
            err, err_rel = _telemetry_norms(params.xyz, pose_3d_gt)
            err_h, err_rel_h = err.unsqueeze(-2), err_rel.unsqueeze(-2)
        use_stop = self.settings.early_stopping == "opt_early_stopping"
        return params, MacroHistory(
            losses=st.losses, error=err_h, error_rel=err_rel_h,
            stopped_at=st.stop_max, hist8=st.carry[2] if use_stop else None)
