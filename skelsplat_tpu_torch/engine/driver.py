"""Training driver: the scene loop behind ``train`` (counterpart of
``skelsplat_tpu/engine/driver.py::training``).

Wires DataLoader records into SceneTrainer runs, writes the on-disk
artifacts (per-scene result PLYs under
``point_cloud/iteration_{it}/{scene}.ply``, ``input.ply``,
``cameras.json``, the debug render and heatmap PNGs), logs per-scene
errors (with the S9 bad-calibration zeroing) and TensorBoard scalars, and
writes ``train_summary.json`` with the sweep's s/scene.

The sweep is the JAX driver's pipelined one, by its rules. Scenes go in
groups of ``training.fetch_scenes`` (default 32; 1 with
``training.pipeline_scenes=false``), and each group's inputs go to the
device in one packed copy (``utils.put_trees``). A group runs as one
``SceneTrainer.optimize_scene_chain`` when ``training.chain_scenes`` is on
(the default), it holds more than one scene of one trainer and one input
signature, ``debug.save_images`` is off and no save comes before the last
iteration; otherwise scene by scene. Either way the early-stop window
passes from scene to scene on the device, so every grouping gives the
serial loop's results bitwise. A group's results come back in one
non-blocking copy (``_Fetch``), started as soon as the group is enqueued
and read after the next group is enqueued: one group stays pending, the
JAX driver's fetch thread without a thread, since the copy is already
asynchronous on the card. Files, log lines and summary rows are written
in dataset order, an early-stopped scene's PLY under its stop iteration.

``training.multichip=true`` with more than one rank (``torchrun``,
``parallel/launch.py``) shards batches of scenes over a (scenes × views)
mesh of ranks (``_training_multichip``); with one rank it runs the batched
or serial path, as the JAX driver does on one device.
``pipeline.debug=true`` checks every macro step's losses, gradients and
parameters for NaN and infinity and raises ``FloatingPointError`` naming
the step (the counterpart of JAX's ``jax_debug_nans``).

``training.scene_batch=B`` runs consecutive scenes of one (W, H, V) shape
B at a time through ``SceneTrainer.optimize_scene_batch``
(``_training_batched``), where nothing needs the per-scene path: no
dropout, no noise, no early stopping and no save before the last
iteration, the JAX driver's rule.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from skelsplat_tpu_torch import losses as loss_registry
from skelsplat_tpu_torch import resolve_device, tracing
from skelsplat_tpu_torch.core.cameras import stack_cameras
from skelsplat_tpu_torch.core.gaussians import (PARAM_FIELDS, SkeletonModel,
                                                init_params, scene_type_of)
from skelsplat_tpu_torch.data import cameras_io, ply
from skelsplat_tpu_torch.data.loader import DataLoader, SceneRecord
from skelsplat_tpu_torch.engine.optim import OptConfig
from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings
from skelsplat_tpu_torch.ops import heatmaps as hm_ops
from skelsplat_tpu_torch.ops import rasterizer
from skelsplat_tpu_torch.parallel import launch
from skelsplat_tpu_torch.renderer_registry import RENDERING_CHANNELS
from skelsplat_tpu_torch.utils import put_trees, tree_leaves

log = logging.getLogger(__name__)

S9_BAD = ["SittingDown 1", "Waiting 1", "Greeting"]


def opt_config_from(opt_group) -> OptConfig:
    return OptConfig(
        iterations=int(opt_group.iterations),
        position_lr_init=float(opt_group.position_lr_init),
        position_lr_final=float(opt_group.position_lr_final),
        position_lr_delay_mult=float(opt_group.position_lr_delay_mult),
        position_lr_max_steps=int(opt_group.position_lr_max_steps),
        feature_lr=float(opt_group.feature_lr),
        opacity_lr=float(opt_group.opacity_lr),
        scaling_lr=float(opt_group.scaling_lr),
        rotation_lr=float(opt_group.rotation_lr),
    )


def train_settings_from(training_group) -> TrainSettings:
    return TrainSettings(
        loss_function=training_group.loss_function,
        lambda_loss_function=float(training_group.lambda_loss_function),
        consistency_loss=training_group.consistency_loss,
        lambda_consistency=float(training_group.lambda_consistency),
        early_stopping=training_group.early_stopping,
        accumulation_steps=int(training_group.accumulation_steps),
        dropout=bool(training_group.dropout),
        std_dev_noise=float(training_group.std_dev_noise),
        view_fusion=str(getattr(training_group, "view_fusion", "mean")),
    )


def check_ported(training_group, settings: TrainSettings, pipe):
    """Raise ``SystemExit`` for an unknown loss, consistency loss or
    rendering, and for several ranks without ``training.multichip=true``
    (each would run the whole sweep into the same files)."""
    if settings.loss_function not in loss_registry.losses:
        raise SystemExit(f"unknown loss {settings.loss_function!r}")
    if settings.consistency_loss not in loss_registry.consistency_losses:
        raise SystemExit(
            f"unknown consistency loss {settings.consistency_loss!r}")
    if pipe.rendering not in RENDERING_CHANNELS:
        raise SystemExit(f"unknown rendering {pipe.rendering!r}")
    if (launch.world_size() > 1
            and not bool(getattr(training_group, "multichip", False))):
        raise SystemExit(f"{launch.world_size()} ranks need "
                         "training.multichip=true")


def batchable(training_group, settings: TrainSettings, save_iterations,
              iterations: int) -> bool:
    """Whether the sweep runs its scenes in batches: ``scene_batch`` > 1
    and nothing that needs the per-scene path (dropout, noise, early
    stopping, whose window spans scene boundaries, or a save before the
    last iteration), as the JAX driver decides."""
    return (int(getattr(training_group, "scene_batch", 1) or 1) > 1
            and not settings.dropout and settings.std_dev_noise == 0.0
            and settings.early_stopping == "no_stopping"
            and all(it >= iterations or it <= 0 for it in save_iterations))


def _parse_scene_name(scene_name: str, data_root: str):
    """(subject, activity, step) of a scene name."""
    if "panoptic" in data_root:
        parts = scene_name.split("_")
        return parts[0], parts[1] + "_" + parts[2], parts[-1]
    subject, activity, step = scene_name.split("_")
    return subject, activity, step


def _save_scene_artifacts(output_dir: str, record: SceneRecord):
    """input.ply, sparse/points3D.ply and cameras.json of a scene,
    overwritten by each scene as the reference does."""
    xyz = record.pose_3d.reshape(-1, 3)
    rgb = np.ones_like(xyz) * 255
    ply.write_point_ply(os.path.join(output_dir, "sparse", "points3D.ply"),
                        xyz, rgb)
    ply.write_point_ply(os.path.join(output_dir, "input.ply"), xyz, rgb)
    cams = [cameras_io.camera_to_json(i, c)
            for i, c in enumerate(record.cameras)]
    with open(os.path.join(output_dir, "cameras.json"), "w") as f:
        json.dump(cams, f)


def to_u8(images, dims):
    """Min-max normalize each image over ``dims`` and quantize to uint8,
    on the images' device."""
    lo = torch.amin(images, dim=dims, keepdim=True)
    rng = torch.amax(images, dim=dims, keepdim=True) - lo
    return ((images - lo) / torch.where(rng > 0, rng, torch.ones_like(rng))
            * 255).to(torch.uint8)


def _write_pngs(images_u8, folder: str, name: str):
    """(V,H,W) uint8 device images → ``folder/{name}_{v}.png``, through
    one host copy."""
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    tracing.synced("driver.save_images", images_u8)
    ims = images_u8.cpu().numpy()
    for v in range(ims.shape[0]):
        Image.fromarray(ims[v]).save(os.path.join(folder, f"{name}_{v}.png"))


def render_u8(params, cameras, W: int, H: int):
    """(V,H,W) uint8: each view's channel-summed render, min-max normalized
    and quantized on the device. All views render in one dense call."""
    with torch.no_grad():
        im = rasterizer.render(params, cameras, W, H)["render"]
        return to_u8(im.sum(dim=1), (1, 2))


def _save_images(trainer: SceneTrainer, params, cameras, output_dir: str,
                 name: str = "render"):
    """Debug PNGs of each view's channel-summed render."""
    _write_pngs(render_u8(params, cameras, trainer.W, trainer.H),
                os.path.join(output_dir, "images"), name)


def _save_heatmaps(gt_heatmaps, output_dir: str, name: str = "heatmap"):
    """Debug PNGs of each view's channel-summed (V,N,H,W) GT heatmaps."""
    with torch.no_grad():
        ims = to_u8(gt_heatmaps.sum(dim=1), (1, 2))
    _write_pngs(ims, os.path.join(output_dir, "heatmaps"), name)


def _log_tb_history(tb_writer, subject, activity, step, losses_k, err_k,
                    err_rel_k, accum):
    """Per-macro TensorBoard scalars under the reference's tag names, from
    host arrays."""
    if tb_writer is None:
        return
    tb_string = f"Subject_{subject}_Activity_{activity}/Step_{step}"
    for k in range(losses_k.shape[0]):
        it = (k + 1) * accum
        tb_writer.add_scalar("train_loss_patches/total_loss",
                             float(losses_k[k].mean()), it)
        tb_writer.add_scalar(tb_string + "/absolute_error",
                             float(err_k[k].mean()), it)
        tb_writer.add_scalar(tb_string + "/relative_error",
                             float(err_rel_k[k].mean()), it)


class _Fetch:
    """One host copy of device tensors, started now and read later: they
    are packed into one flat float32 tensor (the int64 stop iteration is
    exact in it) and, on the GPU, copied without blocking into pinned host
    memory, with an event recorded behind the copy. ``result()`` waits for
    that event alone, so work enqueued after the copy (the next batch) is
    not waited for."""

    def __init__(self, tensors):
        self.shapes = [tuple(t.shape) for t in tensors]
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        self.event = None
        if flat.device.type == "cuda":
            self.host = torch.empty(flat.shape, dtype=flat.dtype,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = flat.cpu()

    def result(self):
        """The tensors as numpy arrays, once the copy has landed."""
        if self.event is not None:
            self.event.synchronize()
            tracing.synced("driver.fetch")
        host = self.host.numpy()
        out, at = [], 0
        for shape in self.shapes:
            n = int(np.prod(shape, dtype=np.int64))
            out.append(host[at:at + n].reshape(shape))
            at += n
        return out

class _Sweep:
    """What the three sweeps share: one trainer per (W, H, V) shape, the
    per-scene write-out and the run's summary."""

    def __init__(self, dataset, model, opt_cfg, settings: TrainSettings,
                 pipe, output_dir: str, tb_writer, log, dev,
                 debug_mode: bool):
        self.data_root, self.output_dir = dataset.data_root, output_dir
        self.model, self.opt_cfg, self.settings = model, opt_cfg, settings
        self.pipe, self.tb_writer, self.log = pipe, tb_writer, log
        self.dev, self.debug_mode = dev, debug_mode
        self.results = []
        self._trainers: dict[tuple, SceneTrainer] = {}

    def trainer(self, W: int, H: int, nviews: int) -> SceneTrainer:
        """The trainer of scenes of the (W, H, V) shape, made at the
        first."""
        key = (W, H, nviews)
        if key not in self._trainers:
            self._trainers[key] = SceneTrainer(
                self.model, self.opt_cfg, self.settings, W, H,
                antialiasing=bool(self.pipe.antialiasing), renderer="auto",
                device=self.dev, debug=self.debug_mode)
        return self._trainers[key]

    def write_scene(self, scene_id, name: str, seconds: float, stop_it: int,
                    err, err_rel, saves, history=None,
                    announce: bool = False) -> dict:
        """A finished scene's files and summary row, from host arrays:
        ``saves`` its checkpoints in iteration order, (iteration, (xyz,
        log_scales, quats, opacity)); ``err``/``err_rel`` its last
        per-joint errors; ``history`` its (losses, error, error_rel) per
        macro step for TensorBoard, or None. ``announce`` prints each
        save. Returns the row."""
        for it, cloud in saves:
            # parameters freeze at the stop, so the first checkpoint at or
            # after it holds the stop's state: it is saved under the stop
            # iteration, and nothing after it
            stopped = bool(stop_it) and it >= stop_it
            it = stop_it if stopped else it
            if announce:
                print(f"Saving iteration {it} for scene {name}")
            ply.write_gaussian_ply(
                os.path.join(self.output_dir, "point_cloud",
                             f"iteration_{it}", f"{name}.ply"), *cloud)
            if stopped:
                break
        subject, activity, step = _parse_scene_name(name, self.data_root)
        if subject == "S9" and activity in S9_BAD:
            err = np.zeros_like(err)    # bad calibration: not logged
        if history is not None:
            _log_tb_history(self.tb_writer, subject, activity, step, *history,
                            self.settings.accumulation_steps)
        row = {"scene_id": scene_id, "scene_name": name,
               "abs_error": float(err.mean()),
               "rel_error": float(err_rel.mean()), "seconds": seconds,
               "stopped_at": stop_it}
        self.results.append(row)
        return row

    def finish(self, per_scene: str, **summary) -> list:
        """Log the sweep's end (``per_scene`` its mean time), write
        ``train_summary.json`` (the rows, then ``summary``'s keys) and
        close TensorBoard. Returns the rows."""
        self.log.info(f"Training completed. {len(self.results)} scenes, "
                      f"{per_scene}")
        with open(os.path.join(self.output_dir, "train_summary.json"),
                  "w") as f:
            json.dump({"scenes": self.results, **summary}, f, indent=2)
        if self.tb_writer is not None:
            self.tb_writer.close()
        print("Training completed.")
        return self.results


def training(dataset, model_group, opt_group, pipe, debug, training_group,
             dataset_loader: DataLoader, output_dir: str,
             dropout_generator: torch.Generator, log=log, device="cuda"):
    """Optimize every scene of ``dataset_loader`` on ``device`` and write
    the run's artifacts under ``output_dir``. ``dropout_generator`` is the
    CPU generator the dropout masks are drawn from (``utils.safe_state``).
    Returns the per-scene summary dicts."""
    dev = resolve_device(device)
    settings = train_settings_from(training_group)
    opt_cfg = opt_config_from(opt_group)
    save_iterations = list(debug.save_iterations)
    if opt_cfg.iterations not in save_iterations:
        save_iterations.append(opt_cfg.iterations)
    check_ported(training_group, settings, pipe)
    debug_mode = bool(getattr(pipe, "debug", False))

    # +debug.tensorboard=false turns the TensorBoard log off, and with it
    # the per-macro telemetry (only each scene's last row is then kept);
    # on a mesh, rank 0 alone writes
    tb_writer = (_prepare_tb(output_dir)
                 if bool(getattr(debug, "tensorboard", True))
                 and launch.rank() == 0 else None)
    scene_type = scene_type_of(dataset.data_root)
    model = SkeletonModel(
        scene_type, dataset_loader.n_joints,
        scaling=float(model_group.scaling),
        scaling_modifier=float(model_group.scaling_modifier),
        opacity_on=bool(model_group.opacity_on))
    if RENDERING_CHANNELS[pipe.rendering] != dataset_loader.n_joints:
        log.warning("pipeline.rendering %s has %d channels but dataset has "
                    "%d joints", pipe.rendering,
                    RENDERING_CHANNELS[pipe.rendering],
                    dataset_loader.n_joints)
    sweep = _Sweep(dataset, model, opt_cfg, settings, pipe, output_dir,
                   tb_writer, log, dev, debug_mode)
    if launch.world_size() > 1:
        return _training_multichip(sweep, dataset_loader, save_iterations,
                                   dropout_generator)
    if batchable(training_group, settings, save_iterations,
                 opt_cfg.iterations):
        return _training_batched(sweep, dataset_loader,
                                 int(training_group.scene_batch))
    if int(getattr(training_group, "scene_batch", 1) or 1) > 1:
        log.info("scene_batch>1 requested but dropout/noise/save_iterations/"
                 "early_stopping need the per-scene path; batching disabled")

    log.info(f"Training on {len(dataset_loader)} scenes")

    # +training.skip_existing=true skips scenes whose final PLY exists in
    # the run dir. Early-stopped scenes save under their stop iteration,
    # which the previous run's summary holds.
    skip_existing = bool(getattr(training_group, "skip_existing", False))
    prev_scenes = {}
    if skip_existing:
        try:
            with open(os.path.join(output_dir, "train_summary.json")) as f:
                prev_scenes = {s["scene_name"]: s
                               for s in json.load(f).get("scenes", [])}
        except (OSError, ValueError):
            pass

    def _done_iteration(name):
        prev = prev_scenes.get(name, {})
        return int(prev.get("stopped_at", 0)) or opt_cfg.iterations

    # the reference makes its early stopper once, before the scene loop, so
    # the 8-loss window spans scene boundaries: it passes from scene to
    # scene as a device tensor (a resumed run starts it afresh)
    hist8_carry = None
    total_opt_seconds = 0.0
    n_run = 0
    # the JAX driver's grouping: fetch_scenes scenes a group (1 without
    # pipelining), chained where the group allows it
    pipeline = bool(getattr(training_group, "pipeline_scenes", True))
    fetch_group = (max(1, int(getattr(training_group, "fetch_scenes", 32)
                              or 1)) if pipeline else 1)
    chain = (bool(getattr(training_group, "chain_scenes", True))
             and pipeline and fetch_group > 1 and not debug.save_images
             and all(it >= opt_cfg.iterations or it <= 0
                     for it in save_iterations))
    prep_buf = []   # (scene_id, record, trainer, host inputs, t0)
    pending = []    # (jobs, _Fetch) of dispatched groups, in dataset order
    sweep_t0 = time.perf_counter()

    def _telemetry(history, g=None):
        """A scene's tensors to fetch (scene ``g`` of a chain's)."""
        sel = (lambda x: x) if g is None else (lambda x: x[g])
        out = [sel(history.stopped_at), sel(history.error)[-1],
               sel(history.error_rel)[-1]]
        if tb_writer is not None:
            out += [sel(history.losses), sel(history.error),
                    sel(history.error_rel)]
        return out

    def _finalize(max_pending: int):
        """Write the files and summary rows of the oldest dispatched
        groups, in dataset order, until ``max_pending`` groups are left."""
        nonlocal total_opt_seconds
        n_tel = 6 if tb_writer is not None else 3
        while len(pending) > max_pending:
            jobs, fetch = pending.pop(0)
            host = fetch.result()
            at = 0
            for scene_id, record, t0, save_its in jobs:
                vals = host[at:at + n_tel + 4 * len(save_its)]
                at += len(vals)
                dt = time.perf_counter() - t0
                total_opt_seconds += dt
                saves = [(it, vals[n_tel + 4 * i:n_tel + 4 * i + 4])
                         for i, it in enumerate(save_its)]
                row = sweep.write_scene(
                    scene_id, record.scene_name, dt, int(vals[0]), vals[1],
                    vals[2], saves,
                    vals[3:6] if tb_writer is not None else None,
                    announce=True)
                log.info(f"Scene {record.scene_name}: "
                         f"abs {row['abs_error']:.2f} "
                         f"rel {row['rel_error']:.2f} ({dt:.2f}s)")

    def _dispatch():
        """Enqueue the buffered group: one ``optimize_scene_chain`` when
        the group is chainable and homogeneous (one trainer, one input
        signature), else scene by scene from one packed copy of the
        group's inputs; then start the group's one result copy and write
        out the group before it."""
        nonlocal hist8_carry, n_run
        if not prep_buf:
            return
        tr0 = prep_buf[0][2]

        def sig(hin):
            return tuple(tuple(x.shape) for x in tree_leaves(hin))

        tensors, jobs = [], []
        if (chain and len(prep_buf) > 1
                and all(p[2] is tr0 and sig(p[3]) == sig(prep_buf[0][3])
                        for p in prep_buf[1:])):
            params_g, history_g = tr0.optimize_scene_chain(
                [p[3] for p in prep_buf], hist8_init=hist8_carry,
                lean=tb_writer is None)
            if history_g.hist8 is not None:
                hist8_carry = history_g.hist8
            # the one save: the last iteration's, stop-aware in _finalize
            last = tr0.n_macro * settings.accumulation_steps
            for g, (scene_id, record, _, _, t0) in enumerate(prep_buf):
                tensors += _telemetry(history_g, g)
                tensors += [getattr(params_g, f)[g] for f in PARAM_FIELDS]
                jobs.append((scene_id, record, t0, [last]))
        else:
            group = put_trees([p[3] for p in prep_buf], dev)
            for (scene_id, record, trainer, _, t0), inputs in zip(prep_buf,
                                                                 group):
                saves = []
                params, history = trainer.optimize_scene(
                    None, None, inputs=inputs,
                    checkpoint_iterations=save_iterations,
                    checkpoint_fn=lambda it, prm, s=saves: s.append((it,
                                                                     prm)),
                    hist8_init=hist8_carry, lean=tb_writer is None)
                if history.hist8 is not None:
                    hist8_carry = history.hist8
                if debug.save_images:
                    _save_images(trainer, params, inputs[2], output_dir,
                                 "render")
                tensors += _telemetry(history)
                tensors += [getattr(prm, f) for _, prm in saves
                            for f in PARAM_FIELDS]
                jobs.append((scene_id, record, t0, [it for it, _ in saves]))
        n_run += len(prep_buf)
        prep_buf.clear()
        pending.append((jobs, _Fetch(tensors)))
        _finalize(1 if pipeline else 0)

    for scene_id, record in dataset_loader:
        nv, n = np.asarray(record.poses_2d).shape[:2]
        if skip_existing and os.path.exists(os.path.join(
                output_dir, "point_cloud",
                f"iteration_{_done_iteration(record.scene_name)}",
                f"{record.scene_name}.ply")):
            log.info(f"Scene {record.scene_name}: already done, skipping")
            _dispatch()
            _finalize(0)    # keep the summary in dataset order
            if settings.dropout:
                # consume this scene's draw, so the masks of the remaining
                # scenes are those of a fresh run
                hm_ops.dropout_masks_torch(nv, n, dropout_generator)
            if record.scene_name in prev_scenes:
                prev = prev_scenes[record.scene_name]
                sweep.results.append(prev)
                total_opt_seconds += float(prev.get("seconds", 0.0))
            continue
        cams_host = cameras_io.build_camera_batch(record.cameras,
                                                  device="cpu")
        W = int(cams_host.width.max())
        H = int(cams_host.height.max())
        trainer = sweep.trainer(W, H, nv)

        _save_scene_artifacts(output_dir, record)
        if debug.save_images and n_run == 0 and not prep_buf:
            # the first scene's GT heatmaps, from its initial covariance
            p0 = init_params(record.pose_3d, model.scene_type, model.scaling,
                             model.scaling_modifier, device=dev)
            spec0 = hm_ops.heatmap_spec(
                p0.xyz, p0.covariance(),
                torch.as_tensor(np.asarray(record.poses_2d)[..., :2],
                                dtype=torch.float32, device=dev),
                cams_host.map(lambda x: x.to(dev)), W, H)
            _save_heatmaps(hm_ops.eval_heatmaps(spec0, W, H), output_dir)

        dmask = (hm_ops.dropout_masks_torch(nv, n, dropout_generator)
                 if settings.dropout else None)
        t0 = time.perf_counter()
        prep_buf.append((scene_id, record, trainer, trainer.host_inputs(
            record.pose_3d, record.poses_2d, cams_host, record.pose_3d_gt,
            drop_mask=dmask), t0))
        if len(prep_buf) >= fetch_group:
            _dispatch()
    _dispatch()
    _finalize(0)

    # the mean is the sweep's wall time: with pipelining a scene's
    # dispatch-to-result interval overlaps the next group's
    sweep_wall = time.perf_counter() - sweep_t0
    n_run = max(n_run, 1)
    return sweep.finish(f"{sweep_wall / n_run:.3f} s/scene mean (wall)",
                        mean_seconds_per_scene=sweep_wall / n_run,
                        sweep_wall_seconds=sweep_wall,
                        sum_scene_latency_seconds=total_opt_seconds,
                        pipelined_scenes=pipeline)


def _training_batched(sweep: _Sweep, dataset_loader: DataLoader,
                      scene_batch: int):
    """The batched sweep (counterpart of the JAX driver's
    ``_training_batched``): consecutive scenes of one (W, H, V) shape in
    groups of up to ``scene_batch``, each group one
    ``optimize_scene_batch`` call, one trainer per shape. Each scene's
    result PLY goes under ``point_cloud/iteration_{stop or iterations}``;
    no debug PNGs are written. One batch stays in flight: batch k's results
    start their copy to the host as soon as batch k is enqueued, and its
    files are written after batch k+1 is enqueued. Per-scene "seconds" is
    the batch's enqueue-to-result time over its size, so batches overlap;
    ``wall_seconds_per_scene`` is the sweep's wall time per scene. On the
    card a batch is replays of its shape's captured step: a tail group of
    another size is another graph."""
    log, tb_writer = sweep.log, sweep.tb_writer
    records = [rec for _, rec in dataset_loader]
    log.info(f"Training on {len(records)} scenes in batches of up to "
             f"{scene_batch}")
    total = 0.0
    sweep_t0 = time.perf_counter()

    def finalize(group, fetch, t0):
        nonlocal total
        host = fetch.result()
        dt = time.perf_counter() - t0
        total += dt
        stopped, err_b, err_rel_b = host[4:7]
        for b, rec in enumerate(group):
            # the one save, the last iteration's
            sweep.write_scene(
                rec.scene_id, rec.scene_name, dt / len(group),
                int(stopped[b]), err_b[b], err_rel_b[b],
                [(sweep.opt_cfg.iterations, [f[b] for f in host[:4]])],
                [h[b] for h in host[7:10]] if tb_writer is not None
                else None)
        log.info(f"Batch of {len(group)} scenes: {dt:.2f}s "
                 f"({dt / len(group):.3f} s/scene)")

    def shape_key(rec):
        cams = cameras_io.build_camera_batch(rec.cameras, device="cpu")
        return (int(cams.width.max()), int(cams.height.max()),
                len(rec.cameras)), cams

    pending = None
    i = 0
    while i < len(records):
        key, cams0 = shape_key(records[i])
        group, cams = [records[i]], [cams0]
        i += 1
        while i < len(records) and len(group) < scene_batch:
            key2, cams2 = shape_key(records[i])
            if key2 != key:
                break
            group.append(records[i])
            cams.append(cams2)
            i += 1
        trainer = sweep.trainer(*key)
        _save_scene_artifacts(sweep.output_dir, group[-1])
        t0 = time.perf_counter()
        params, history = trainer.optimize_scene_batch(
            np.stack([r.pose_3d for r in group]),
            np.stack([np.asarray(r.poses_2d)[..., :2] for r in group]),
            stack_cameras(cams), np.stack([r.pose_3d_gt for r in group]),
            lean=tb_writer is None)
        telemetry = [params.xyz, params.log_scales, params.quats,
                     params.opacity_logit, history.stopped_at,
                     history.error[:, -1], history.error_rel[:, -1]]
        if tb_writer is not None:
            telemetry += [history.losses, history.error, history.error_rel]
        fetch = _Fetch(telemetry)
        # batch k-1's files, now that batch k is enqueued behind its copy
        if pending is not None:
            finalize(*pending)
        pending = (group, fetch, t0)
    if pending is not None:
        finalize(*pending)

    n = max(len(sweep.results), 1)
    wall = time.perf_counter() - sweep_t0
    return sweep.finish(f"{wall / n:.3f} s/scene mean (wall)",
                        mean_seconds_per_scene=total / n,
                        wall_clock_sweep_seconds=wall,
                        wall_seconds_per_scene=wall / n)


def _training_multichip(sweep: _Sweep, dataset_loader: DataLoader,
                        save_iterations, dropout_generator: torch.Generator):
    """The sweep on a (scenes × views) mesh of the process group's ranks
    (counterpart of the JAX driver's ``_training_multichip``): views split
    over the ``views`` axis where they divide (``choose_mesh``), scenes
    over the rest. Scenes go ``scenes_axis`` at a time through
    ``multichip_optimize`` (a tail group is padded by repeating its last
    scene, whose extra results are dropped), one trainer per (W, H, V).
    Every rank draws every real scene's dropout mask, in dataset order,
    from its own copy of the seeded generator, so the ranks stay in step.
    Rank 0 alone writes the PLYs (checkpoints buffered, an early-stopped
    scene's saved under its stop iteration and none after), TensorBoard
    and ``train_summary.json``; it receives the other shards' results once
    per mesh batch."""
    from skelsplat_tpu_torch.parallel.mesh import (batch_scene_records,
                                                   choose_mesh, make_mesh,
                                                   multichip_optimize)

    log, settings = sweep.log, sweep.settings
    rank0 = launch.rank() == 0
    records = [rec for _, rec in dataset_loader]
    nviews = len(records[0].cameras)
    scenes_axis, views_axis = choose_mesh(launch.world_size(), nviews)
    mesh = make_mesh(scenes_axis, views_axis, device_type=sweep.dev.type)
    if rank0:
        log.info(f"multichip mesh: {{'scenes': {scenes_axis}, "
                 f"'views': {views_axis}}}")
        if settings.early_stopping != "no_stopping":
            # the reference's stopper window straddles scene boundaries, a
            # serial effect no parallel schedule reproduces
            log.warning("multichip: %s windows reset per mesh batch (the "
                        "reference's cross-scene stopper state is inherently "
                        "serial; the per-scene path keeps it exactly)",
                        settings.early_stopping)

    total = 0.0
    for i in range(0, len(records), scenes_axis):
        group = records[i:i + scenes_axis]
        pad = scenes_axis - len(group)
        group_p = group + [group[-1]] * pad
        cams_list = [cameras_io.build_camera_batch(r.cameras, device="cpu")
                     for r in group_p]
        W = int(max(c.width.max() for c in cams_list))
        H = int(max(c.height.max() for c in cams_list))
        trainer = sweep.trainer(W, H, nviews)
        init_b, gt_b, p2d_b, cams_b = batch_scene_records(group_p, cams_list)
        drop_b = None
        if settings.dropout:
            masks = [hm_ops.dropout_masks_torch(nviews, p2d_b.shape[2],
                                                dropout_generator)
                     for _ in group]
            drop_b = np.stack(masks + [masks[-1]] * pad)

        saves = []
        t0 = time.perf_counter()
        _, hist_b = multichip_optimize(
            mesh, trainer, init_b, p2d_b, cams_b, gt_b, drop_b=drop_b,
            checkpoint_iterations=save_iterations,
            checkpoint_fn=lambda it, prm: saves.append((it, prm)))
        if not rank0:
            continue
        host = _Fetch([hist_b.stopped_at, hist_b.losses, hist_b.error,
                       hist_b.error_rel]
                      + [t for _, prm in saves for t in
                         (prm.xyz, prm.log_scales, prm.quats,
                          prm.opacity_logit)]).result()
        dt = time.perf_counter() - t0
        total += dt
        stopped, losses_b, err_b, err_rel_b = host[:4]
        for b, rec in enumerate(group):
            saves_b = [(it, [f[b] for f in host[4 + 4 * j:8 + 4 * j]])
                       for j, (it, _) in enumerate(saves)]
            sweep.write_scene(rec.scene_id, rec.scene_name, dt / len(group),
                              int(stopped[b]), err_b[b, -1],
                              err_rel_b[b, -1], saves_b,
                              (losses_b[b], err_b[b], err_rel_b[b]))
        log.info(f"mesh batch of {len(group)}: {dt:.2f}s")
    if not rank0:
        return sweep.results
    n = max(len(sweep.results), 1)
    return sweep.finish(f"{total / n:.3f} s/scene mean",
                        mean_seconds_per_scene=total / n)


def _prepare_tb(output_dir):
    """A TensorBoard writer under ``output_dir/tb``, or None (with the
    reference's message) where TensorBoard does not import."""
    os.makedirs(output_dir, exist_ok=True)
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(output_dir + "/tb")
    except ImportError:
        print("Tensorboard not available: not logging progress")
        return None
