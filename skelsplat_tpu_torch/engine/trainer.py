"""Per-scene optimization engine (counterpart of
``skelsplat_tpu/engine/trainer.py``).

The reference renders one view per iteration round-robin and steps Adam
every ``accumulation_steps`` iterations with xyz grad = mean of the per-view
grads and scale/rot/opacity grads from the last rendered view only. Since
the parameters are constant between optimizer steps, one macro step is:
render all visited views at the current parameters, combine gradients,
step. Here a macro step is a batch over the visited views (one preprocess
over (A, N), one kernel launch for all A views), and the scene is a Python
loop over macro steps that never waits on the device: every decision
(early stop, freezing after it) is a tensor select.

Early stopping is exact for every (nviews, accumulation_steps): the
reference's 8-loss window check runs against a rolling history, and a
mid-macro stop steps with the reference's mixed fresh/stale gradients.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from skelsplat_tpu_torch import losses as loss_registry
from skelsplat_tpu_torch import resolve_device
from skelsplat_tpu_torch.core.cameras import Camera
from skelsplat_tpu_torch.core.gaussians import (GaussianParams, SkeletonModel,
                                                init_params)
from skelsplat_tpu_torch.engine.optim import AdamGroups, OptConfig
from skelsplat_tpu_torch.ops import cuda_raster
from skelsplat_tpu_torch.ops import heatmaps as hm
from skelsplat_tpu_torch.ops import rasterizer
from skelsplat_tpu_torch.ops.fused import FUSED_LOSSES, make_fused_view_loss

REPEAT_TOL = 1e-6  # OptEarlyStopping repeat_tolerance
RENDERERS = ("cuda", "fused", "dense")


def stop_offset(hist8, cur, tol):
    """First inner-iteration offset m ∈ {1..A} at which the reference's
    8-loss window check fires during this macro step.

    ``hist8`` holds the 8 most recent per-iteration losses (+inf-padded
    while the history is short); ``cur`` this macro's A per-view losses in
    visit order. After m of them the check compares full[m+4:m+8] with
    full[m:m+4] of the concatenated (8+A,) vector; a window touching a pad
    entry compares false (|inf−x| = inf, |inf−inf| = nan).

    Returns (stop_now, m_star, new_hist8) with m_star = A when no stop and
    new_hist8 the 8 losses ending at the stop offset.
    """
    A = cur.shape[0]
    full = torch.cat([hist8, cur])
    conds = torch.stack([
        torch.all(torch.abs(full[m:m + 4] - full[m + 4:m + 8]) < tol)
        for m in range(1, A + 1)])
    stop_now = torch.any(conds)
    m_star = torch.where(stop_now, torch.argmax(conds.to(torch.uint8)) + 1,
                         torch.full((), A, dtype=torch.int64,
                                    device=cur.device))
    new_hist8 = full[m_star + torch.arange(8, device=full.device)]
    return stop_now, m_star, new_hist8


def _telemetry_norms(pred, pose_3d_gt):
    """Absolute and pelvis-relative per-joint errors."""
    err = torch.linalg.vector_norm(pred - pose_3d_gt, dim=1)
    err_rel = torch.linalg.vector_norm(
        (pred - pred[0]) - (pose_3d_gt - pose_3d_gt[0]), dim=1)
    return err, err_rel


def _last_visit_rows(acc_gx, grads_xyz, idxs, m_star):
    """The reference's sequential ``accumulated_grads[view] = grad`` writes
    of visit offsets j < m_star (the last visit of a view wins; other rows
    keep their stale value), as one gather."""
    A, nv = idxs.shape[0], acc_gx.shape[0]
    offs = torch.arange(A, device=idxs.device)
    visits = ((idxs[:, None] == torch.arange(nv, device=idxs.device)[None, :])
              & (offs[:, None] < m_star))
    j_last = torch.amax(torch.where(visits, offs[:, None],
                                    torch.full_like(visits, -1, dtype=offs.dtype)),
                        dim=0)
    return torch.where((j_last >= 0)[:, None, None],
                       grads_xyz[torch.clamp(j_last, min=0)], acc_gx)


def compose_macro(adam: AdamGroups, V_accum: int, use_stop: bool,
                  general: bool, carry, k, losses_v, grads_v: GaussianParams,
                  idxs, pose_3d_gt, spatial_lr_scale, lean: bool = False):
    """One macro step's gradient composition + Adam update + telemetry.

    ``carry`` = (params, opt_state, [hist8,] stopped[, acc_gx]);
    ``losses_v``/``grads_v`` hold the A visited views' losses/grads in visit
    order (leading axis A), ``idxs`` their view indices, ``k`` the 0-based
    macro index as a device tensor. Returns (new_carry, rec) with rec =
    (losses_v, err, err_rel, stop_mark), or (losses_v, stop_mark) when
    ``lean``.
    """
    acc_gx = None
    if general or use_stop:
        carry, acc_gx = carry[:-1], carry[-1]
    if use_stop:
        params, opt_state, hist8, stopped = carry
        stop_now, m_star, hist8_new = stop_offset(hist8, losses_v, REPEAT_TOL)
        # after a stop the reference leaves its loop: the history freezes
        hist8 = torch.where(stopped, hist8, hist8_new)
    else:
        params, opt_state, stopped = carry
        stop_now = torch.zeros((), dtype=torch.bool, device=losses_v.device)
        m_star = torch.full((), V_accum, dtype=torch.int64,
                            device=losses_v.device)
    if general:
        acc_gx = _last_visit_rows(acc_gx, grads_v.xyz, idxs, m_star)
        g_xyz = torch.mean(acc_gx, dim=0)
    elif use_stop:
        row_new = torch.arange(V_accum, device=m_star.device)[:, None, None] < m_star
        acc_gx = torch.where(row_new, grads_v.xyz, acc_gx)
        g_xyz = torch.mean(acc_gx, dim=0)
    else:
        g_xyz = torch.mean(grads_v.xyz, dim=0)
    # the last visited view (A−1 without a stop), as an index tensor: a
    # Python int would wait for the device
    oidx = (m_star - 1).reshape(1)
    grads = GaussianParams(g_xyz, *(
        torch.index_select(g, 0, oidx)[0]
        for g in (grads_v.log_scales, grads_v.quats, grads_v.opacity_logit)))
    iteration = k * V_accum + m_star

    new_params, new_opt = adam.step(params, grads, opt_state, iteration,
                                    spatial_lr_scale)
    apply = torch.logical_not(stopped)
    params2 = new_params.map(lambda a, b: torch.where(apply, a, b), params)
    opt2 = dataclasses.replace(
        new_opt,
        m=new_opt.m.map(lambda a, b: torch.where(apply, a, b), opt_state.m),
        v=new_opt.v.map(lambda a, b: torch.where(apply, a, b), opt_state.v),
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
                     general: bool):
    """The carry matching compose_macro's layout (accumulated_grads starts
    at zero and persists across macro steps)."""
    dev = params.xyz.device
    acc0 = ((torch.zeros((nviews,) + tuple(params.xyz.shape),
                         dtype=torch.float32, device=dev),)
            if (general or use_stop) else ())
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    if use_stop:
        hist8 = torch.full((8,), float("inf"), dtype=torch.float32, device=dev)
        return (params, opt_state, hist8, stopped) + acc0
    return (params, opt_state, stopped) + acc0


def extent_from_centers(centers) -> float:
    """The per-scene spatial LR scale from (V, 3) camera centers: 1.1 × the
    max distance from their centroid."""
    centers = np.asarray(centers, dtype=np.float64)
    center = centers.mean(axis=0, keepdims=True)
    diagonal = np.linalg.norm(centers - center, axis=1).max()
    return float(diagonal * 1.1)


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


@dataclasses.dataclass(frozen=True)
class MacroHistory:
    """Per-macro-step telemetry, on the device."""

    losses: torch.Tensor      # (K, A) per-visit total losses
    error: torch.Tensor       # (K, N) per-joint absolute error ‖pred−gt‖
    error_rel: torch.Tensor   # (K, N) root-aligned error
    stopped_at: torch.Tensor  # int64, iteration of the early stop (0 = none)
    hist8: torch.Tensor | None = None  # final loss window (early stopping)


class SceneTrainer:
    """Runs the full per-scene optimization on one device.

    ``renderer``: "cuda" (the hand-written kernel; its plain PyTorch
    version on the CPU), "fused" (the row-chunk autograd stream) or "dense"
    (full images through the autograd oracle and the loss registry).
    """

    def __init__(self, model: SkeletonModel, opt: OptConfig,
                 settings: TrainSettings, width: int, height: int,
                 antialiasing: bool = False, renderer: str = "cuda",
                 device="cuda"):
        self.device = resolve_device(device)
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
        if renderer != "dense" and settings.loss_function not in FUSED_LOSSES:
            raise ValueError(f"renderer {renderer!r} does not implement "
                             f"{settings.loss_function!r}")
        self.renderer = renderer
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
                          reduction="mean")
        cons_fn = loss_registry.consistency_losses[
            self.settings.consistency_loss]
        cons = cons_fn(params.xyz, self.model.scene_type, reduction="mean")
        return main + cons * self.settings.lambda_consistency

    def _prepare(self, initial_pose, poses_2d, cameras, drop_mask):
        """Parameters (from the (N,3) numpy ``initial_pose``) and the GT state
        from the INITIAL covariance, once per scene."""
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

    def _per_view_grads(self, params, cameras, view_aux, poses_2d, A):
        """(losses (A,), grads with a leading A axis) of the visited views:
        one batched forward with per-view parameter copies, one backward."""
        p = params.map(lambda x: x.detach().unsqueeze(0).expand(
            (A,) + tuple(x.shape)).clone().requires_grad_(True))
        with torch.enable_grad():
            losses = self._view_loss(p, cameras, view_aux, poses_2d)
            grads = torch.autograd.grad(
                losses.sum(), [p.xyz, p.log_scales, p.quats, p.opacity_logit])
        return losses.detach(), GaussianParams(*grads)

    def host_inputs(self, initial_pose, poses_2d, pose_3d_gt=None,
                    drop_mask=None):
        """Host-side input normalization: dtypes and the dropout mask (a
        host-drawn (V,N) bool mask, used when ``settings.dropout``).
        Returns numpy (initial_pose, poses_2d, pose_3d_gt, drop_mask)."""
        initial_pose = np.asarray(initial_pose, dtype=np.float32)
        if pose_3d_gt is None:
            pose_3d_gt = np.zeros_like(initial_pose)
        poses_2d = np.ascontiguousarray(np.asarray(poses_2d)[..., :2],
                                        dtype=np.float32)
        nviews, n = poses_2d.shape[0], poses_2d.shape[1]
        if self.settings.dropout and drop_mask is not None:
            drop_mask = np.asarray(drop_mask, dtype=bool)
        else:
            drop_mask = np.zeros((nviews, n), dtype=bool)
        return (initial_pose, poses_2d,
                np.asarray(pose_3d_gt, dtype=np.float32), drop_mask)

    def optimize_scene(self, initial_pose, poses_2d, cameras: Camera,
                       pose_3d_gt=None, drop_mask=None, lean: bool = False):
        """Run the full optimization of one scene.

        initial_pose (N,3); poses_2d (V,N,2+); cameras a batched Camera;
        pose_3d_gt (N,3) for telemetry (zeros if absent). Returns
        (params, MacroHistory), all on the device: nothing in the loop
        waits for it. ``lean`` keeps only the last telemetry row (K=1).
        """
        dev = self.device
        init_np, p2d_np, gt_np, drop_np = self.host_inputs(
            initial_pose, poses_2d, pose_3d_gt, drop_mask)
        extent = torch.tensor(extent_from_centers(
            cameras.cam_center.detach().cpu().numpy()), dtype=torch.float32,
            device=dev)
        cameras = cameras.map(lambda x: x.to(dev))
        poses_2d, pose_3d_gt, drop_mask = (
            torch.as_tensor(a, device=dev) for a in (p2d_np, gt_np, drop_np))

        A = self.settings.accumulation_steps
        nviews = poses_2d.shape[0]
        general = A != nviews
        use_stop = self.settings.early_stopping == "opt_early_stopping"
        params, view_aux = self._prepare(init_np, poses_2d, cameras,
                                         drop_mask)
        carry = init_macro_carry(params, self.adam.init(params), nviews,
                                 use_stop, general)

        K = self.n_macro
        ks = torch.arange(K, dtype=torch.int64, device=dev)
        # the reference visits views (k·A + j) mod V during macro step k
        idx_all = (ks[:, None] * A + torch.arange(A, device=dev)) % nviews
        rows = 1 if lean else K
        losses_h = torch.zeros((rows, A), dtype=torch.float32, device=dev)
        stop_max = torch.zeros((), dtype=torch.int64, device=dev)
        err_h = err_rel_h = None
        if not lean:
            n = poses_2d.shape[1]
            err_h = torch.zeros((K, n), dtype=torch.float32, device=dev)
            err_rel_h = torch.zeros((K, n), dtype=torch.float32, device=dev)

        for k in range(K):
            idxs = idx_all[k]
            if general:
                cams_k = cameras.take(idxs)
                aux_k = (view_aux[idxs] if self.renderer == "dense"
                         else view_aux.take(idxs))
                p2d_k = poses_2d[idxs]
            else:
                cams_k, aux_k, p2d_k = cameras, view_aux, poses_2d
            losses_v, grads_v = self._per_view_grads(
                carry[0], cams_k, aux_k, p2d_k, A)
            carry, rec = compose_macro(
                self.adam, A, use_stop, general, carry, ks[k], losses_v,
                grads_v, idxs, pose_3d_gt, extent, lean=lean)
            losses_h[0 if lean else k] = rec[0]
            stop_max = torch.maximum(stop_max, rec[-1])
            if not lean:
                err_h[k] = rec[1]
                err_rel_h[k] = rec[2]

        params = carry[0]
        if lean:
            err, err_rel = _telemetry_norms(params.xyz, pose_3d_gt)
            err_h, err_rel_h = err[None], err_rel[None]
        return params, MacroHistory(
            losses=losses_h, error=err_h, error_rel=err_rel_h,
            stopped_at=stop_max, hist8=carry[2] if use_stop else None)
