#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU (sm_90a, e.g. an H100).

    python3 chip_smoke.py [--profile]

Phases, each failing the script (nonzero exit) on any error:

1. build   — nvcc builds the kernels from skelsplat_tpu_torch/csrc
             (one nvcc per source, run together);
             prints the build time, ptxas' register report, registers,
             spill bytes and resident blocks per SM of every K1/K2 tile
             kernel instantiation, and the card's name and power limit.
2. kernels — K1 (raster_loss_grad) and K2 (raster_loss) against their plain
             PyTorch versions on the card at H36M size (4 views, 1002×1000
             grid, 17 joints): a mixed 1000/1002-wide rig with l2_gaussian,
             the same with l1_gaussian, a rig with one splat behind a
             camera, a 19-joint rig, the mixed rig with one view that
             has no live tile, and a batched macro step's 32 views (8
             scenes, each seen by its own mixed rig). C must match exactly;
             S and each gradient component of dg within the stated
             tolerance; the view with no live tile gives S, C and dg
             exactly 0; two K1 runs must be bitwise equal; the live-tile
             list each kernel built must equal live_tiles_plain's. Times
             each kernel, its plain version and its bound, and K1 again
             on the 32 views. Then kernels A (preprocess_pack) and B
             (preprocess_grad) at the benchmark cells' macro steps (4
             views at 1002×1000 with 17 joints, 4 at 1920×1080 with 19,
             512 at 1920×1080 with 19): A's outputs bitwise its plain
             version's, B's losses and gradients within 1e-5 of each
             field's largest magnitude of its plain version's and of
             autograd's (make_cuda_view_loss with per-view copies); then
             kernel C (compose_adam) from B's outputs there, 125 macro
             steps lean and with the full history against the torch
             composite it replaces (compose_macro + record_step): every
             state tensor bitwise but the telemetry norms (their largest
             distance in ulp reported), one launch a step; each timed
             beside its plain version and its bound by bytes. Last, K1
             at each benchmark cell's call (k1_variants.CELLS: 4 views
             of 1002×1000 with 17 joints, 4 of 1920×1080 with 19, 128
             Panoptic frames' 512 views): bitwise its run of one, the
             views on both sides of each of the tile kernel's 256-view
             windows (all views of a chain's call) held to its plain
             version as above, the batch's 512 views bitwise each
             scene's own 4-view call, each kernel's device time, its
             bound and its run length.
3. path    — one synthetic H36M frame (4 views at 1002×1000, 17 joints,
             500 iterations = 125 macro steps, l2_gaussian + limb
             consistency) through SceneTrainer.optimize_scene(renderer=
             "cuda"), the captured path (the first frame warms up and
             captures the step graph, phases 6 and 7 replay theirs
             too). The launch counts are read around optimize_scene
             alone: exactly 125 K1 launches and no K2 launch (the path
             always takes gradients, as the JAX path does). Asserts finite
             xyz, falling MPJPE, and a falling no-grad loss (K2, scored
             outside the counted window); then times TIMED_FRAMES more frames
             (s/frame, through a host copy of xyz).
4. agree   — 12 iterations of renderer="cuda" against renderer="fused"
             (the autograd row-chunk stream) on the card: xyz within 1e-4.
5. measure — the kernel-measurement path. K3's SASS (csrc/
             issue_rate.cu) keeps one instruction per step. Then, with
             the launch counts read around them alone: ``roofline
             --probe`` (the four issue rates at 1, 2 and 4 chains, K1's
             activity and its two bounds) and ``kernel_probe --dead
             --live-slots`` (K1's live and dead times, the live one within
             10% of phase 2's, and the fit of time against flagged
             pairs). K1's and K2's measured-rate bounds are taken on phase
             2's timed inputs. K3 then matches its plain version
             bitwise on the inputs and sizes of every probe it ran (the
             exp chain is exactly 0 from its third step on, so for exp
             the SASS count, not the values, checks the body). Last, a
             torch.profiler trace of a few K1 launches read back by
             ``trace_summary`` with the launch count checked (taken
             again, up to 50 times, while the profiler drops kernel
             records).
6. cli     — the sweep users run: a synthetic H36M tree from the port's
             tools/make_synthetic_dataset.py (subjects S9 and S11, 64
             frames at step 64 = 4 scenes, the H36M size table's mixed
             1002/1000 x 1000 rig) under build/smoke/, trained in-process
             by ``skelsplat_tpu_torch.train.main`` with the port's
             h36m.yaml (17 joints, 500 iterations, accumulation 4,
             save_images) changed only in data_root, end_scene_id=4 and
             the run dir, then scored by ``skelsplat_tpu_torch.eval.main``.
             The launch counts are read around train.main alone: exactly
             500 K1 launches (125 a scene) and no K2. Checks every
             artifact (the 4 result PLYs, input.ply, cameras.json, the
             render and heatmap PNGs, train_summary.json), finite logged
             errors, finite MPJPE, and an absolute MPJPE below the
             initial guess's; prints the sweep's s/scene.
7. batch   — the batched sweep: a 10-scene synthetic H36M tree at full
             size (subjects S9 and S11, 192 frames at step 64, the first
             10 scenes) under build/smoke/batch/, trained by train.main
             with h36m.yaml, 500 iterations and save_images off, twice:
             training.scene_batch=1 (exactly 1250 K1 launches) and
             training.scene_batch=8 (groups of 8 and 2: exactly 250 K1
             launches and no K2), each counted around its train.main
             alone; both scored by eval.main. Checks every PLY, per-scene
             logged errors of the two runs within BATCH_ATOL_MM, their
             absolute MPJPE within BATCH_ATOL_MM, and the batched MPJPE
             below the initial guesses'. Prints the largest per-scene
             |Δxyz| between the runs, the serial s/scene, the batched
             wall s/scene and a full batch's s/scene, then times
             TIMED_BATCHES batches of 8 synthetic frames alone through
             SceneTrainer.optimize_scene_batch (s/scene of a full batch,
             through a host copy of xyz).

8. options — the training options and entry points beyond H36M's
             defaults, each counted around its own call: (a) a Panoptic
             sweep (panoptic.yaml, 19 joints, 4 views at 1920x1080, 500
             iterations, DATASET_SCENES scenes of a synthetic tree) and
             (b) an Occlusion-Person sweep (occlusion-person.yaml, 15
             joints, 1280x720, scaling_modifier 1.25), each exactly 125
             K1 launches a scene and an MPJPE below the initial guesses',
             with K1 held against its plain version and timed at the
             sweep's (N, W, H); (c) one H36M scene at 1002/1000x1000 with
             the soft-argmax loss l1_masked_huber, which renderer "auto"
             sends through the dense renderer: 0 K1 launches, its peak
             device memory and s/scene, and each view's loss and xyz
             gradient at the initial parameters against the same call on
             the CPU; (d) one H36M scene with
             view_fusion=confidence_weighted through K1 (125 launches);
             (e) the triangulation entry point over (a)'s tree on the card
             against the same on the CPU; (f) the render entry point over
             (a)'s run: 4 PNGs a scene.
9. extras  — the eval extras and the 3DGS compatibility surface: (a)
             ``skelsplat_tpu_torch.eval.main`` with eval.image_metrics=true
             over phase 6's run (4 scenes, 1002/1000x1000, 17 channels)
             with random VGG LPIPS weights (seed 0) written as an npz: 0 K1
             launches, SSIM, LPIPS, s/scene and peak device memory; one
             scene's metrics on the CPU against the card's (SSIM within
             SSIM_ATOL, LPIPS within LPIPS_RTOL: the check that the eval
             path runs its convolutions in full f32), and LPIPS alone on
             one scene's 4 views by CUDA events with its peak memory; (b)
             ``tools/bench_ssim.py`` at 5x1x1080x1920 (plain, fused, fused
             and plain forward + backward, the fused backward against
             autograd through the plain SSIM); (c) the native codec's bulk
             read of phases 6 and 7's result clouds, bitwise against the
             numpy reader, with both times; (d) a GaussianModel from a
             Scene: Adam steps on a dense render loss, densify_and_prune,
             reset_opacity and a PLY round trip.
10. multichip — the (scenes × views) mesh of parallel/mesh.py at full
             width (4 views at 1002/1000x1000, 17 joints, 500 iterations):
             (a) multichip_optimize on a (1,1) mesh of one NCCL rank over
             2 synthetic scenes, each scene's xyz and history bitwise
             against optimize_scene_batch of the same scenes, exactly 125
             K1 launches counted around the call, and its s/scene; (b) the
             CLI as a user runs it: train.main with training.multichip=true
             on 2 ranks spawned by parallel/launch.py that share the card
             (gloo on CUDA tensors, mesh (1,2): each rank renders 2 views)
             over phase 6's tree, its PLYs within MULTICHIP_ATOL_MM of
             phase 6's serial sweep and its MPJPE within MULTICHIP_ATOL_MM
             of phase 6's, rank 1 printing nothing, and its s/scene beside
             phase 6's; (c) dryrun_multichip(2) on the card (a doctored
             scene stops at iteration 8, renderer cuda against fused); (d)
             tools/parity_study over 2 scenes at the h36m preset: dense,
             fused and cuda through 500 iterations, every pair's largest
             pose disagreement within PARITY_MM.
11. tools  — the data-preparation path: (a) the H36M test set at its
             size (S9 and S11, 60 activities, 2,181 frames x 4 cameras,
             seeded synthetic motions seen by phase 6's rig): one dump of
             monocular 3D predictions (the GT plus noise and a per-camera
             offset) and 2D detections through
             ``tools.h36m.preprocess_metrabs_predictions``, then
             ``tools.h36m.compute_initial_guess`` (main(argv)) on the card
             (twice) and on the CPU: every fused pose within FUSE_ATOL_MM,
             the tool's wall ms and its fuse_poses ms on each, and the
             fused MPJPE below the mean single-camera MPJPE; (b) on a copy
             of phase 6's tree, the same kind of predictions fused on the
             card, then train.main from those guesses
             (dataset.initial_guess=metrabs_resnet, TOOLS_SCENES scenes,
             h36m.yaml otherwise unchanged) and eval.main: exactly 125 K1
             launches a scene, counted around train.main alone, and an
             MPJPE below the fused guesses'; (c) phase 8 (e)'s
             triangulation clouds through
             ``tools.preprocess_triang_initial_guess``: every frame
             bitwise one cloud's xyz, each cloud once, sorted within its
             file.
12. graphs — the captured path against the eager one
             (SceneTrainer(eager=True)), in this call: (a) one H36M frame
             as in phase 3, a warm-up frame then GRAPH_FRAMES timed frames
             of each, interleaved: xyz bitwise on every frame, s/frame of
             each (median), the graph's capture and instantiate time and
             nodes, exactly 125 K1 launches a frame by the counter and
             by the profiler's kernel rows of a captured frame (taken
             again while the profiler drops records), and the device
             busy share of a captured frame; (b) phase 6's tree through
             train.main with opt_early_stopping and save_images off,
             chained (fetch_scenes=4: one optimize_scene_chain) against
             pipeline_scenes=false: 500 K1 launches each, summary rows
             and PLY bytes equal, s/scene of each; (c) phase 7's 10
             scenes in its batches (8 + 2) through optimize_scene_batch,
             eager and captured, twice each: xyz bitwise, and bitwise
             phase 7's batched PLYs, s/scene of each second pass. On
             each of (a), (b) and (c), the tracing counter
             k1_run_length must hold every K1 call at the run length
             cuda_raster.run_length gives its shape (captured steps
             counted per replay).
13. renderers — the fused and dense renderers' scenes as captured
             programs, in this call: (a) phase 8 (c)'s dense soft-argmax
             scene (l1_masked_huber, phase 6's first scene) through
             SceneTrainer.optimize_scene, captured (warm-up and capture),
             eager, captured again: xyz bitwise, s/scene of each, the
             graph's nodes and capture time, peak device memory of each
             run, 0 K1 launches, the MPJPE beside phase 8 (c)'s and PR 6's
             12.3404 mm; one eager macro step at full size under
             torch.cuda.set_sync_debug_mode("error"); (b) phase 3's H36M
             frame with renderer="fused" the same way (the sync check, then
             captured, eager, captured: s/frame of each, bitwise); (c)
             graft_entry.entry() on the card: the loss against the same
             forward on the CPU (rtol GRAFT_RTOL), then the forward
             captured as a graph and replayed, bitwise its eager value,
             with the eager and replayed times by CUDA events.
14. prepare — each scene's prepare inside its captured program, in a
             child process of this call that has never profiled (a
             torch.profiler session leaves its hooks on, and a graph
             replay's launch then costs ~10x the host time): (a) phase
             3's captured frame in that process (s/frame), then a warm
             optimize_scene_chain of 4 H36M scenes (opt_early_stopping)
             and a warm optimize_scene_batch of 8 under
             torch.cuda.set_sync_debug_mode("error"): no synchronizing
             call, each returns with its device work still running (host
             and device seconds by CUDA events), exactly 625 K1 launches;
             (b) the vectorized prepare (_prepare_batch) against B
             one-scene _prepare calls at B = 8, 32, 128 and 512 on the
             H36M rig (and B = 8 at 3 views, where each scene's rows lie
             at another alignment): bitwise, their times (host through a
             synchronize, device by CUDA events) and the vectorized
             prepare's peak memory; (c) the prepare programs of (a)'s two
             shapes: nodes, capture and instantiate time, the memory
             their capture reserved, a replay's time; (d) phase 7's 10
             scenes through train.main chained (fetch_scenes=4: groups of
             4, 4 and 2), with the TensorBoard log (the default) and
             without it (+debug.tensorboard=false), the PLYs of the two
             byte-equal: the sweep's wall time split by host timers
             (loader, trainer set-up, cameras and artifacts, host_inputs,
             the packed copy, the first group's dispatch and the later
             ones', the fetch, PLY writes, TensorBoard scalars, eval.main)
             and each group's device time by CUDA events, every group's
             dispatch returning before its device work ends; each sweep's
             s/scene against (a)'s s/frame. The main process then prints
             phase 12 (b)'s chained s/scene against phase 12 (a)'s
             captured s/frame.
15. bench  — the benchmark entry point (skelsplat_tpu_torch/bench.py,
             bench.main as a user calls it), in a child process of this
             call that has never profiled: (a) the default invocation
             (h36m, 64 frames, groups of 32): its JSON line (the root
             bench's four keys, a finite value) and exactly 20,125 K1
             launches (125 x (65 latency frames + 32 warm-chain scenes +
             64 swept)); (b) h36m-occ, panoptic and op at 8 frames in
             groups of 4: 2,625 K1 launches each, and h36m-occ's swept
             xyz bitwise a serial optimize_scene loop over the same
             scenes and dropout masks in a trainer of its own; (c)
             --batch 8 at 8 frames in groups of 4: 3,000 launches (375
             for the warm batch and the two timed ones), finite batch
             xyz, value the batch's s/frame; (d) --profile last (1 frame),
             its chrome trace read back by tools/trace_summary.py with
             the frame's 125 records of each of K1's two kernels (the
             invocation taken again while the profiler drops records).
             Prints each invocation's latency, sweep and batch s/frame
             and the phase's wall time.

The line before the last is {"kernels": [...], "off_path_kernels": [...]}:
"kernels" lists the kernels the paths launched (K1 on the frame, with
its launches on the CLI sweep as "launches_cli", on the batched sweep as
"launches_batch" and its time, plain time and bounds on a batch's 32
views as "*_v32"; on phase 8's Panoptic, Occlusion-Person and fusion runs
as "launches_panoptic", "launches_occlusion_person" and
"launches_fusion", and its time, plain time and bounds at Panoptic's and
Occlusion-Person's shapes as "*_panoptic" and "*_occlusion_person"; on
phase 10 (a)'s mesh run as "launches_multichip"; on phase 11 (b)'s sweep
as "launches_tools"; in phase 12 (a)'s profiled captured frame as
"launches_captured_frame"; on phase 14 (a)'s checked chain and batch as
"launches_chain_batch" and on its chained sweep (d) as
"launches_chained_split"; on phase 15 (a)'s default bench run as
"launches_bench" and on (b)'s and (c)'s runs as "launches_bench_runs";
kernels A and B with K1's launch counts, each asserted equal to K1's on
its path, and their times, plain times and bounds at the H36M, Panoptic
and batch macro steps, the latter two as "*_panoptic" and "*_batch128";
kernel C the same, its counts K1's but 0 on the fusion run and on phase
14 (a)'s chain and batch (the routing keeps the torch composite there
and under phase 12 (b)'s early stopping) and 125 a scene on the dense
and fused scenes;
K3 on the measurement path), "off_path_kernels" those
the port holds that no path launches (K2, launches 0); the last line is
{"ok": true, "device": {...}}. ``--profile`` adds a torch.profiler pass
over one frame and over one batch of 8 frames (device time by kernel,
device busy share).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

W, H, N_JOINTS, N_VIEWS = 1002, 1000, 17, 4
MIXED_WIDTHS = (1002, 1000, 1002, 1000)
ITERATIONS = 500
TIMED_FRAMES = 3  # timed frames after the checked one
TIMED_BATCHES = 2  # phase 7's timed batches of SCENE_BATCH frames
# the kernels optimize_scene launches (K1, kernels A, B and C) and K3, the
# measurement path's; the port's other kernel, K2 (raster_loss), is the
# no-grad loss, which the path never evaluates
PATH_KERNELS = ("raster_loss_grad", "preprocess_pack", "preprocess_grad",
                "compose_adam", "issue_rate")
LIVE_SLOTS = ("0", "1", "2", "4", "8", "12", "17")
TRACE_LAUNCHES = 5
TRACE_ATTEMPTS = 50
TRACE_DIR = Path(__file__).resolve().parent / "build" / "traces"
SMOKE_DIR = Path(__file__).resolve().parent / "build" / "smoke"
CLI_SCENES = 4
BATCH_SCENES = 10
SCENE_BATCH = 8
BATCH_DIR = SMOKE_DIR / "batch"
# per-scene logged error and absolute MPJPE, batched sweep against serial:
# a tenth of the port's 0.5 mm end-check bar
BATCH_ATOL_MM = 0.05
OPTION_DIR = SMOKE_DIR / "options"
DATASET_SCENES = 2
# phase 8's dataset sweeps: (config, (width, height), joints)
DATASETS = (("panoptic", (1920, 1080), 19),
            ("occlusion-person", (1280, 720), 15))
SOFTARGMAX_LOSS = "l1_masked_huber"
# card against CPU, dense soft-argmax path: each view's xyz gradient
# relative to its largest |component|. The two devices' expf round
# differently in the last place at some pixels, and the soft-argmax's
# beta = 100 multiplies that into the gradient: 100x the renderers' 1e-6
# (on the CPU, the port against JAX's op-by-op dense path: 4.1e-5)
DENSE_GRAD_RTOL = 1e-4
TRI_REL = 1e-9
# phase 9, card against CPU on one scene: SSIM's mean over ~1e6 pixels
# and LPIPS at the JAX package's own bar against a torch oracle; TF32
# convolutions would break the LPIPS bound
SSIM_ATOL = 1e-6
LPIPS_RTOL = 2e-4
EXTRAS_DIR = SMOKE_DIR / "extras"
SSIM_SHAPE = ("5", "1", "1080", "1920")   # the JAX tool's default
COMPAT_STEPS = 3
MULTICHIP_DIR = SMOKE_DIR / "multichip"
MULTICHIP_SCENES = 2
# phase 10 (b) against phase 6: the same sweep, its views split over two
# ranks; the port's CLI is held to JAX's at this bar on the CPU
MULTICHIP_ATOL_MM = 1e-3
# phase 10 (d): three renderers through 500 iterations. The renderers'
# ~1e-6 relative differences grow through Adam to 1.358e-4 mm at most
# over 2 scenes on the H100 (dense vs fused); the bar is the top of the
# 1e-4 to 1e-2 mm range predicted for it
PARITY_MM = 1e-2
TOOLS_DIR = SMOKE_DIR / "tools"
GRAPH_DIR = SMOKE_DIR / "graphs"
PREPARE_DIR = SMOKE_DIR / "prepare"
CHAIN_GROUP = 4    # phase 14's chained group, the driver's fetch_scenes
PREPARE_BATCHES = (8, 32, 128, 512)   # phase 14 (b)'s batch sizes
PHASE14_TIMEOUT_S = 400
# phase 15: the bench's shorter runs (frames, group), their presets, the
# batch size of (c), the child's time limit and (d)'s profiled runs at most
BENCH_SHORT = ("--frames", "8", "--group", "4")
BENCH_PRESETS = ("h36m-occ", "panoptic", "op")
BENCH_BATCH = 8
PHASE15_TIMEOUT_S = 420
BENCH_PROFILE_ATTEMPTS = 5
BENCH_DIR = SMOKE_DIR / "bench"
GRAPH_FRAMES = 3   # phase 12 (a)'s timed frames of each mode, after a warm-up
TOOLS_SCENES = 2
# phase 13 (a): the dense soft-argmax scene's MPJPE in PR 6's run
DENSE_MPJPE_PR6 = 12.3404
# phase 13 (c): the entry's loss, card against CPU (the root entry's bar)
GRAFT_RTOL = 1e-5
# phase 11 (a, b): per-camera monocular predictions, the GT plus noise and a
# per-camera offset (each N(0, MONO_SIGMA_MM) per coordinate: ~36 mm from
# the GT per joint)
MONO_SIGMA_MM = 16.0
# the fusion in float64, card against CPU: poses of thousands of mm round
# at ~1e-13 mm, so any larger difference is an error of the port
FUSE_ATOL_MM = 1e-9
# dg tolerance relative to the largest |dg| of the same view and gradient
# component (px, py, a, b, c or opa) over the slots: both sides sum ~1e5
# per-pixel f32 terms, the kernel by warp/tile trees and the plain version
# by torch's reductions, so only the summation order differs; that order
# moves the sums by ~2e-7 of this scale on an H100, 50x inside the bound
DG_RTOL = 1e-5
# phase 2's macro steps for kernels A and B, the benchmark cells' (name,
# scene type, scenes, W, H): the first is the row's, the others its
# "*_panoptic" and "*_batch128" fields
STEP_SHAPES = (("h36m", "h36m", 1, 1002, 1000),
               ("panoptic", "panoptic", 1, 1920, 1080),
               ("batch128", "panoptic", 128, 1920, 1080))
# kernel B against its plain version and against autograd of the
# renderer's loss, each field relative to its largest magnitude; the limb
# prior's weight there, 1,000x the configs' so that it shows
STEP_RTOL = 1e-5
STEP_LAMBDA = 1e-2
# the tile kernel reads its views' list lengths 256 views (its block) at a
# time; phase 2 holds the views on both sides of each window's edge to
# the plain version
K1_WINDOW = 256


def kernel_inputs(widths, behind_camera: bool, seed: int,
                  n_joints: int = N_JOINTS, dead_view=None, scenes: int = 1):
    """Depth-sorted packs of one synthetic frame at a perturbed pose, with
    every slot of ``dead_view`` (if given) dead; with ``scenes`` > 1, of
    that many frames' views at once, each frame seen by its own rig (a
    batched macro step)."""
    from skelsplat_tpu_torch.tools import kernel_probe

    if scenes > 1:
        return kernel_probe.probe_inputs_batch(scenes, W, H, device="cuda",
                                               widths=widths, perturb=True)
    pack, p1s, p2s, img = kernel_probe.probe_inputs(
        W, H, n_joints=n_joints, n_views=N_VIEWS, seed=seed, device="cuda",
        widths=widths, behind_camera=behind_camera, perturb=True)
    if dead_view is not None:
        pack, p1s = kernel_probe.keep_slots(pack, p1s, 0, views=[dead_view])
    return pack, p1s, p2s, img


def dg_rel_err(dg, dgp):
    """(6,) worst |dg − dgp| per gradient component, each relative to the
    largest |dgp| of its view and component over the slots."""
    scale = dgp.abs().amax(dim=1, keepdim=True)
    assert bool((scale > 0).all()), "a view has an all-zero gradient component"
    return ((dg - dgp).abs() / scale).amax(dim=(0, 1))


def check_live_list(name, live, ref):
    """The live-tile list a kernel call built against live_tiles_plain's:
    the counts, and each view's first live_n entries and slot masks."""
    (idx, mask, n), (idx_p, mask_p, n_p) = live, ref
    assert torch.equal(n, n_p), f"{name}: live_n {n.tolist()} vs {n_p.tolist()}"
    for v, k in enumerate(n_p.tolist()):
        assert torch.equal(idx[v, :k], idx_p[v, :k]) and \
            torch.equal(mask[v, :k], mask_p[v, :k]), f"{name}: view {v} list"


def phase_kernels():
    from skelsplat_tpu_torch.ops import cuda_raster as cr
    from skelsplat_tpu_torch.tools.roofline import kernel_bound
    from skelsplat_tpu_torch.tools.timing import cuda_ms

    # (name, widths, behind camera, l1, seed, joints, view with no live
    # tile, scenes)
    cases = [("mixed rig, l2_gaussian", MIXED_WIDTHS, False, False, 0, 17, None,
              1),
             ("mixed rig, l1_gaussian", MIXED_WIDTHS, False, True, 0, 17, None,
              1),
             ("splat behind camera 0, l2_gaussian", None, True, False, 5, 17,
              None, 1),
             ("19-joint rig, l2_gaussian", None, False, False, 0, 19, None, 1),
             ("mixed rig with view 2 dead, l2_gaussian", MIXED_WIDTHS, False,
              False, 0, 17, 2, 1),
             (f"{SCENE_BATCH} scenes' mixed rigs, {SCENE_BATCH * N_VIEWS} "
              f"views, l2_gaussian", MIXED_WIDTHS, False, False, 0, 17, None,
              SCENE_BATCH)]
    err = {"raster_loss_grad": 0.0, "raster_loss": 0.0}
    for name, widths, behind, l1, seed, n_joints, dead, scenes in cases:
        pack, p1s, p2s, img = kernel_inputs(widths, behind, seed, n_joints,
                                            dead, scenes)
        before = _launches()
        S, C, dg, live = cr.raster_loss_grad(pack, p1s, p2s, img, l1,
                                             return_live=True)
        S_b, C_b, dg_b = cr.raster_loss_grad(pack, p1s, p2s, img, l1)
        S2, C2, live2 = cr.raster_loss(pack, p1s, p2s, img, l1,
                                       return_live=True)
        torch.cuda.synchronize()
        launched = _launches(since=before)
        assert launched["raster_loss_grad"] == 2
        assert launched["raster_loss"] == 1
        Sp, Cp, dgp = cr.raster_loss_grad_plain(pack, p1s, p2s, img, l1)
        S2p, C2p = cr.raster_loss_plain(pack, p1s, p2s, img, l1)
        ref = cr.live_tiles_plain(pack, H, W)
        torch.cuda.synchronize()
        check_live_list(f"{name}, K1", live, ref)
        check_live_list(f"{name}, K2", live2, ref)
        assert torch.equal(S, S_b) and torch.equal(C, C_b) \
            and torch.equal(dg, dg_b), f"{name}: two K1 runs differ"
        assert torch.equal(C, Cp) and torch.equal(C2, C2p), \
            f"{name}: C {C.tolist()} vs plain {Cp.tolist()}"
        views = [v for v in range(pack.shape[0]) if v != dead]
        assert bool((C[views] > 0).all()), f"{name}: empty mask"
        if dead is not None:
            assert int(ref[2][dead]) == 0
            assert float(S[dead]) == 0.0 and int(C[dead]) == 0 \
                and float(S2[dead]) == 0.0 and int(C2[dead]) == 0 \
                and float(dg[dead].abs().max()) == 0.0, \
                f"{name}: the dead view's outputs are not exactly 0"
        assert torch.isfinite(dg).all() and torch.isfinite(S).all(), name
        torch.testing.assert_close(S, Sp, rtol=1e-5, atol=0)
        torch.testing.assert_close(S2, S2p, rtol=1e-5, atol=0)
        rel = dg_rel_err(dg[views], dgp[views])
        assert float(rel.max()) <= DG_RTOL, \
            f"{name}: dg off by {rel.tolist()} of its scale per component"
        if behind:
            assert float(dg[0, -1].abs().max()) == 0.0, \
                "the culled splat sorts last in view 0 and gets no gradient"
        err["raster_loss_grad"] = max(err["raster_loss_grad"],
                                      float((dg - dgp).abs().max()),
                                      float((S - Sp).abs().max()))
        err["raster_loss"] = max(err["raster_loss"],
                                 float((S2 - S2p).abs().max()))
        print(f"  {name}: S {S.tolist()} C {C.tolist()} live tiles "
              f"{ref[2].tolist()} |dS| {float((S - Sp).abs().max()):.3g} "
              f"dg rel err per component (px py a b c opa) "
              f"{[float(f'{r:.3g}') for r in rel.tolist()]}", flush=True)
    # times at the main path's shapes (uniform 1002x1000 rig, l2)
    timed = kernel_inputs(None, False, 0)
    pack, p1s, p2s, img = timed
    rows = []
    for name, line, grad, fn, plain in (
            ("raster_loss_grad", 466, True, cr.raster_loss_grad,
             cr.raster_loss_grad_plain),
            ("raster_loss", 320, False, cr.raster_loss, cr.raster_loss_plain)):
        ms, stream_ms = cuda_ms(lambda: fn(pack, p1s, p2s, img, False),
                                reps=200, each_kernel_once=True)
        plain_ms, plain_stream_ms = cuda_ms(
            lambda: plain(pack, p1s, p2s, img, False), reps=3, warmup=1)
        b_ms, b_by = kernel_bound(pack, p1s, p2s, img, grad)["published"]
        rows.append({"name": name, "route": "cuda",
                     "source": "skelsplat_tpu_torch/csrc/raster_loss.cu",
                     "replaces": f"skelsplat_tpu/ops/pallas_raster.py:{line}",
                     "launches": None, "max_abs_err": err[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        print(f"  {name}: {ms:.4f} ms/call device time ({stream_ms:.4f} ms "
              f"back to back); plain {plain_ms:.2f} ms device time "
              f"({plain_stream_ms:.2f} back to back); bound {b_ms:.6f} ms by "
              f"{b_by}", flush=True)
    # K1 again at a batched macro step's shapes (8 scenes' 32 views)
    timed_b = kernel_inputs(MIXED_WIDTHS, False, 0, scenes=SCENE_BATCH)
    ms, stream_ms = cuda_ms(lambda: cr.raster_loss_grad(*timed_b, False),
                            reps=200, each_kernel_once=True)
    plain_ms, _ = cuda_ms(lambda: cr.raster_loss_grad_plain(*timed_b, False),
                          reps=2, warmup=1)
    b_ms, b_by = kernel_bound(*timed_b, True)["published"]
    rows[0].update({"ms_v32": ms, "plain_ms_v32": plain_ms,
                    "bound_ms_v32": b_ms, "bound_by_v32": b_by})
    print(f"  raster_loss_grad on {timed_b[0].shape[0]} views: {ms:.4f} "
          f"ms/call device time ({stream_ms:.4f} ms back to back); plain "
          f"{plain_ms:.2f} ms; bound {b_ms:.6f} ms by {b_by}", flush=True)
    rows[0]["cells"] = k1_at_cells()
    return rows, phase_step_kernels(), timed, timed_b


def k1_run_length(V: int, width: int, height: int, n_joints: int) -> int:
    """The run length K1's tile kernel takes on a call over V views."""
    from skelsplat_tpu_torch.ops import _build, cuda_raster as cr

    return cr.run_length(V, _build.n_tiles(width, height), cr.persistent_grid(
        torch.cuda.current_device(), True, False, n_joints))


def k1_at_cells() -> dict:
    """K1 at each benchmark cell's call (``k1_variants.CELLS``): each
    kernel's device time, the bound and the tile kernel's run length; the
    outputs bitwise those of a run of one, the views on both sides of each
    ``K1_WINDOW`` edge (every view of a 4-view call) within phase 2's
    tolerances of the plain version, and a batch's views bitwise each
    scene's own 4-view call."""
    from skelsplat_tpu_torch.ops import cuda_raster as cr
    from skelsplat_tpu_torch.tools import k1_variants
    from skelsplat_tpu_torch.tools.roofline import kernel_bound
    from skelsplat_tpu_torch.tools.timing import cuda_ms

    out = {}
    for cell, w, h, n, scenes in k1_variants.CELLS:
        x = k1_variants.cell_inputs(w, h, n, scenes)
        V = x[0].shape[0]
        R = k1_run_length(V, w, h, n)
        got = cr.raster_loss_grad(*x, False)
        one = cr._launch(*x, False, True, run=1)[:3]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, one)), \
            f"{cell}: K1 at R = {R} differs from R = 1"
        views = sorted({v for e in range(K1_WINDOW, V, K1_WINDOW)
                        for v in range(e - N_VIEWS, e + N_VIEWS)}
                       | set(range(max(V - N_VIEWS, 0), V)))
        S, C, dg = (t[views] for t in got)
        Sp, Cp, dgp = cr.raster_loss_grad_plain(*(t[views] for t in x),
                                                False)
        torch.cuda.synchronize()
        assert torch.equal(C, Cp) and bool((C > 0).all()), (cell, C, Cp)
        torch.testing.assert_close(S, Sp, rtol=1e-5, atol=0)
        rel = dg_rel_err(dg, dgp)
        assert float(rel.max()) <= DG_RTOL, (cell, rel.tolist())
        for s in range(scenes if scenes > 1 else 0):
            sl = slice(N_VIEWS * s, N_VIEWS * (s + 1))
            own = cr.raster_loss_grad(*(t[sl].contiguous() for t in x), False)
            assert all(torch.equal(a, b[sl]) for a, b in zip(own, got)), \
                f"{cell}: scene {s} differs from its own 4-view call"
        per = {}
        ms, _ = cuda_ms(lambda: cr.raster_loss_grad(*x, False),
                        reps=20 if scenes > 1 else 200,
                        each_kernel_once=True, per_kernel=per)
        b_ms, b_by = kernel_bound(*x, True)["published"]
        tile = sum(t for k, t in per.items() if "raster_loss_live" in k)
        lists = sum(t for k, t in per.items() if "live_tiles" in k)
        out[cell] = {"views": V, "run_length": R, "ms": ms, "tile_ms": tile,
                     "live_tiles_ms": lists, "bound_ms": b_ms,
                     "bound_by": b_by, "plain_views": views,
                     "dg_rel_err": rel.tolist()}
        print(f"  K1 at {cell}'s call ({V} views of {w}x{h}, {n} joints, "
              f"R = {R}, bitwise R = 1"
              + (" and each scene's own call" if scenes > 1 else "")
              + f"; views {views[0]}..{views[-1]} ({len(views)}) against "
              f"plain: C exact, dg rel err per component "
              f"{[float(f'{r:.3g}') for r in rel.tolist()]}): {ms:.4f} "
              f"ms/call device time (raster_loss_live {tile:.4f}, "
              f"live_tiles {lists:.4f}); bound {b_ms:.6f} ms by {b_by}",
              flush=True)
    return out


def _rel_err(pairs) -> float:
    """The worst |got − want| over (got, want) pairs, each relative to the
    largest |want| of its pair."""
    return max(float((g - w).abs().max() / w.abs().max()) for g, w in pairs)


def phase_step_kernels():
    """Kernels A, B and C at each of STEP_SHAPES' macro steps: A's outputs
    bitwise its plain version's, B's losses and gradients (from the same
    K1 outputs) within STEP_RTOL of its plain version's and of autograd's,
    C from B's outputs against the torch composite (``_check_compose_adam``);
    each timed beside its plain version and its bound by bytes (each input
    byte read once, each output byte written once, at the published
    bandwidth). Returns the three kernel rows."""
    from skelsplat_tpu_torch.core.gaussians import PARAM_FIELDS
    from skelsplat_tpu_torch.ops import cuda_preprocess as cp
    from skelsplat_tpu_torch.ops import cuda_raster as cr
    from skelsplat_tpu_torch.tools.kernel_probe import (autograd_step,
                                                        step_inputs)
    from skelsplat_tpu_torch.tools.roofline import PEAK_BYTES_PER_S
    from skelsplat_tpu_torch.tools.timing import cuda_ms

    rows = {name: {"name": name, "route": "cuda",
                   "source": "skelsplat_tpu_torch/csrc/preprocess.cu",
                   "replaces": None, "launches": None, "max_abs_err": 0.0,
                   "bound_by": "bytes", "library_ms": None}
            for name in ("preprocess_pack", "preprocess_grad")}
    for label, st, ns, w, h in STEP_SHAPES:
        params, cams, prof, A = step_inputs(st, ns, w, h, device="cuda")
        limbs = cp.limb_pairs("3D_length_consistency", st)

        def fwd():
            return cp.preprocess_pack(params, cams, prof, A)

        def bwd():
            return cp.preprocess_grad(params, cams, order, S, C, dg, A, w, h,
                                      False, limbs, STEP_LAMBDA)

        def fwd_plain():
            return cp.preprocess_pack_plain(params, cams, prof, A)

        def bwd_plain():
            return cp.preprocess_grad_plain(params, cams, order, S, C, dg, A,
                                            w, h, False, limbs, STEP_LAMBDA)

        before = _launches()
        out_a = fwd()
        pack, order, p1s, p2s = out_a
        S, C, dg = cr.raster_loss_grad(pack, p1s, p2s, prof.img, False)
        losses, grads = bwd()
        torch.cuda.synchronize()
        launched = _launches(since=before)
        assert launched == {
            "raster_loss_grad": 1, "raster_loss": 0, "preprocess_pack": 1,
            "preprocess_grad": 1, "compose_adam": 0, "issue_rate": 0}, \
            (label, launched)
        for got, want in zip(out_a, fwd_plain()):
            assert got.dtype == want.dtype and torch.equal(got, want), label
        got = [losses] + [getattr(grads, f) for f in PARAM_FIELDS]
        assert all(bool(torch.isfinite(g).all()) for g in got), label
        ref_l, ref = bwd_plain()
        plain = [ref_l] + [getattr(ref, f) for f in PARAM_FIELDS]
        auto_l, auto = autograd_step(params, cams, prof, A, False,
                                     "l2_gaussian", st,
                                     "3D_length_consistency", STEP_LAMBDA)
        autograd = [auto_l] + [auto[f] for f in PARAM_FIELDS]
        rel_plain = _rel_err(zip(got, plain))
        rel_auto = _rel_err(zip(got, autograd))
        print(f"  kernels A, B at {label} ({A * ns} views, {w}x{h}, "
              f"N={order.shape[1]}): A bitwise its plain version; B's worst "
              f"relative error {rel_plain:.3g} against its plain version, "
              f"{rel_auto:.3g} against autograd", flush=True)
        assert rel_plain <= STEP_RTOL and rel_auto <= STEP_RTOL, \
            (label, rel_plain, rel_auto)
        b_err = max(float((g - p).abs().max()) for g, p in zip(got, plain))
        rows["preprocess_grad"]["max_abs_err"] = max(
            rows["preprocess_grad"]["max_abs_err"], b_err)

        V, N = order.shape
        param_bytes, cam_bytes = 4 * ns * N * 11, 4 * V * 38
        # A: parameters, cameras, profiles, B and spans in; records, order
        # and the profiles in slot order out. B: parameters, cameras,
        # order, S, C and dg in; losses and gradients out.
        a_bytes = (param_bytes + cam_bytes + 8 * (p1s.numel() + p2s.numel())
                   + 4 * V * N * 5 + 4 * pack.numel() + 4 * order.numel())
        b_bytes = (param_bytes + cam_bytes + 4 * V * N * 7 + 4 * V * 2
                   + 4 * V * (1 + N * 11))
        suffix = "" if label == STEP_SHAPES[0][0] else f"_{label}"
        for name, fn, plain_fn, nbytes in (
                ("preprocess_pack", fwd, fwd_plain, a_bytes),
                ("preprocess_grad", bwd, bwd_plain, b_bytes)):
            ms, stream_ms = cuda_ms(fn, reps=200, each_kernel_once=True)
            plain_ms, _ = cuda_ms(plain_fn, reps=20, warmup=1)
            bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            rows[name].update({f"ms{suffix}": ms,
                               f"plain_ms{suffix}": plain_ms,
                               f"bound_ms{suffix}": bound_ms})
            print(f"  {name} at {label}: {ms:.5f} ms/call device time "
                  f"({stream_ms:.5f} ms back to back); plain {plain_ms:.4f} "
                  f"ms; bound {bound_ms:.7f} ms by bytes", flush=True)
        rows["compose_adam"] = _check_compose_adam(
            rows.get("compose_adam"), label, suffix, st, params, losses,
            grads)
    return list(rows.values())


def _check_compose_adam(row, label: str, suffix: str, scene_type: str,
                        params, losses, grads):
    """Kernel C at one of STEP_SHAPES' macro steps, from kernel B's losses
    and gradients there: 125 macro steps of it against the torch
    composite it replaces (``compose_macro`` + ``record_step``) from the
    same loop state, lean (the cells') and with the full history, every
    state tensor bitwise but the telemetry norms, within NORM_ULPS, whose
    largest distance in ulp it reports; one launch a step; then timed beside the composite
    and its bound by bytes. Returns ``row`` (made on the first shape) with
    this shape's fields."""
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine import trainer as ttrainer
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.ops.compose_adam import NORM_ULPS
    from skelsplat_tpu_torch.tools.roofline import PEAK_BYTES_PER_S
    from skelsplat_tpu_torch.tools.timing import cuda_ms
    from skelsplat_tpu_torch.utils import tree_leaves

    row = row or {"name": "compose_adam", "route": "cuda",
                  "source": "skelsplat_tpu_torch/csrc/compose_adam.cu",
                  "replaces": None, "launches": None, "max_abs_err": 0.0,
                  "norm_ulps": 0, "bound_by": "bytes", "library_ms": None}
    A = 4
    n = params.xyz.shape[-2]
    lead = tuple(params.xyz.shape[:-2])
    opt = (OptConfig() if scene_type == "h36m" else
           OptConfig(position_lr_init=5e-3, opacity_lr=5e-3))
    tr = ttrainer.SceneTrainer(SkeletonModel(scene_type, n), opt,
                               ttrainer.TrainSettings(), W, H,
                               renderer="cuda", eager=True)
    losses_v = losses.reshape(lead + (A,))
    grads_v = grads.map(lambda g: g.reshape(lead + (A,)
                                            + tuple(g.shape[1:])))
    extent = torch.full(lead, 3000.0, device="cuda")
    gt = params.xyz + 25.0

    def kernel(st, lean):
        return lambda: ttrainer.compose_adam_step(
            tr.adam, st, losses_v, grads_v, gt, extent, lean)

    def composite(st, lean):
        def run():
            carry, rec = ttrainer.compose_macro(
                tr.adam, A, False, False, st.carry, st.step, losses_v,
                grads_v, None, gt, extent, lean=lean)
            ttrainer.record_step(st, carry, rec, lean)
        return run

    for lean in (True, False):
        st_c = tr._loop_state(params, A, None, lean)
        st_t = tr._loop_state(params, A, None, lean)
        before = _launches()
        run_c, run_t = kernel(st_c, lean), composite(st_t, lean)
        for _ in range(tr.n_macro):
            run_c()
            run_t()
        torch.cuda.synchronize()
        assert _launches(since=before)["compose_adam"] == tr.n_macro, label
        norms = [] if lean else [(st_c.error, st_t.error),
                                 (st_c.error_rel, st_t.error_rel)]
        for a, b in zip(tree_leaves(st_c), tree_leaves(st_t)):
            if any(a is x for x, _ in norms):
                continue
            assert a.dtype == b.dtype and torch.equal(a, b), (label, lean)
        for a, b in norms:
            ulps = int((a.view(torch.int32).long()
                        - b.view(torch.int32).long()).abs().max())
            assert ulps <= NORM_ULPS, (label, lean, ulps)
            row["norm_ulps"] = max(row["norm_ulps"], ulps)
    assert int(st_c.step) == tr.n_macro
    print(f"  kernel C at {label} ({int(np.prod(lead, dtype=np.int64))} "
          f"scenes of N={n}): 125 macro steps, parameters, moments, step "
          f"counts and history bitwise the torch composite's; telemetry "
          f"norms within {row['norm_ulps']} ulp", flush=True)
    # lean, as the cells run it: the losses row 0 takes every step
    st_c = tr._loop_state(params, A, None, True)
    st_t = tr._loop_state(params, A, None, True)
    ms, stream_ms = cuda_ms(kernel(st_c, True), reps=200,
                            each_kernel_once=True)
    plain_ms, _ = cuda_ms(composite(st_t, True), reps=20, warmup=1)
    S = int(np.prod(lead, dtype=np.int64))
    # parameters and both moments in and out; xyz's A gradients and the
    # other groups' last one, the losses, the step counts, extents and the
    # counter in; the losses row, the step counts and the counter out
    nbytes = (2 * 3 * 4 * S * 11 * n + 4 * S * (A * 3 * n + 8 * n)
              + 4 * S * (A + 2) + 8 + 4 * S * (A + 1) + 8)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    row.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                f"bound_ms{suffix}": bound_ms})
    print(f"  compose_adam at {label}: {ms:.5f} ms/call device time "
          f"({stream_ms:.5f} ms back to back); plain (the torch composite) "
          f"{plain_ms:.4f} ms; bound {bound_ms:.7f} ms by bytes", flush=True)
    return row


def make_trainer(iterations: int, renderer: str, eager: bool = False):
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings

    return SceneTrainer(SkeletonModel("h36m", N_JOINTS, scaling=3.0,
                                      scaling_modifier=1.0),
                        OptConfig(iterations=iterations), TrainSettings(),
                        W, H, renderer=renderer, device="cuda", eager=eager)


def frame_loss(pose, p2d, cams, xyz=None):
    """(V,) no-grad kernel loss (K2) of a frame at its initial parameters,
    or with ``xyz`` in place of the initial means."""
    from skelsplat_tpu_torch.core.gaussians import init_params
    from skelsplat_tpu_torch.ops import cuda_raster, heatmaps

    params = init_params(pose, "h36m", 3.0, 1.0, device="cuda")
    spec = heatmaps.heatmap_spec(params.xyz, params.covariance(),
                                 torch.as_tensor(p2d, device="cuda"), cams,
                                 W, H)
    prof = cuda_raster.view_profiles(spec, W, H)
    if xyz is not None:
        params = type(params)(xyz, params.log_scales, params.quats,
                              params.opacity_logit)
    with torch.no_grad():
        return cuda_raster.fused_view_loss_cuda(params, cams, prof, W, H)


def phase_path(profile: bool):
    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch.synthetic import mpjpe, synthetic_inputs

    init, gt, p2d, cams_np = synthetic_inputs(1 + TIMED_FRAMES, W, H,
                                              n_views=N_VIEWS,
                                              n_joints=N_JOINTS, seed=0)
    cams = compat.camera_from_numpy(cams_np, device="cuda")
    trainer = make_trainer(ITERATIONS, "cuda")
    loss0 = frame_loss(init[0], p2d[0], cams)
    torch.cuda.synchronize()

    before = _launches()
    t0 = time.perf_counter()
    params, hist = trainer.optimize_scene(init[0], p2d[0], cams, gt[0],
                                          lean=True)
    xyz = params.xyz.cpu().numpy()
    first_s = time.perf_counter() - t0
    counts = _launches(since=before)
    loss1 = frame_loss(init[0], p2d[0], cams, xyz=params.xyz)

    assert xyz.shape == (N_JOINTS, 3) and np.isfinite(xyz).all()
    e0, e1 = mpjpe(init[0], gt[0]), mpjpe(xyz, gt[0])
    l0, l1 = loss0.cpu().numpy(), loss1.cpu().numpy()
    print(f"  frame 0: MPJPE {e0:.3f} -> {e1:.3f} mm, loss {l0.tolist()} -> "
          f"{l1.tolist()}, launches {counts}, {first_s:.3f} s with warm-up",
          flush=True)
    assert e1 < e0, "MPJPE did not fall"
    assert (l1 < l0).all(), "the per-view loss did not fall"
    assert counts == _step_launches(ITERATIONS // 4), counts
    assert int(hist.stopped_at) == 0

    times, errs = [], []
    for s in range(1, 1 + TIMED_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, _ = trainer.optimize_scene(init[s], p2d[s], cams, gt[s],
                                           lean=True)
        xyz = params.xyz.cpu().numpy()
        times.append(time.perf_counter() - t0)
        assert np.isfinite(xyz).all()
        errs.append((mpjpe(init[s], gt[s]), mpjpe(xyz, gt[s])))
    print(f"  timed frames: {[round(t, 6) for t in times]} s; MPJPE "
          f"{[(round(a, 3), round(b, 3)) for a, b in errs]} mm", flush=True)
    assert all(b < a for a, b in errs)
    s_per_frame = float(np.median(times))

    if profile:
        profile_run(lambda: trainer.optimize_scene(init[1], p2d[1], cams,
                                                   gt[1], lean=True),
                    s_per_frame, "frame")
    return counts, s_per_frame, (e0, e1)


def profile_run(run, s_unprofiled: float, unit: str):
    """Device time by kernel and the device busy share over one ``run``
    (a frame or a batch of frames, returning (params, history)): the sum
    of kernel durations over the profiled wall time, and over the
    unprofiled time ``s_unprofiled`` (the profiler slows the host, not the
    kernels). The wrapper ranges' device-side copies (user annotations,
    which span the kernels they launch) are left out, so no kernel counts
    twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, _ = run()
        params.xyz.cpu()
        wall = time.perf_counter() - t0
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation), reverse=True)
    assert rows, "the profiler recorded no kernel"
    busy = sum(r[0] for r in rows) / 1e6
    print(f"  profile of one {unit}: {sum(r[1] for r in rows)} kernels, "
          f"device busy {busy:.4f} s = {busy / wall:.4f} of the profiled "
          f"wall {wall:.4f} s, {busy / s_unprofiled:.4f} of the unprofiled "
          f"{s_unprofiled:.4f} s", flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"    {dev_us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")


def phase_agree():
    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch.synthetic import synthetic_inputs

    init, gt, p2d, cams_np = synthetic_inputs(1, W, H, n_views=N_VIEWS,
                                              n_joints=N_JOINTS, seed=0)
    cams = compat.camera_from_numpy(cams_np, device="cuda")
    out = {}
    for r in ("cuda", "fused"):
        params, hist = make_trainer(12, r).optimize_scene(
            init[0], p2d[0], cams, gt[0])
        out[r] = (params.xyz.cpu().numpy(), hist.losses.cpu().numpy())
    dx = float(np.abs(out["cuda"][0] - out["fused"][0]).max())
    dl = float(np.abs(out["cuda"][1] / out["fused"][1] - 1).max())
    print(f"  12 iterations: max |Δxyz| {dx:.3g} mm, max loss rel diff "
          f"{dl:.3g}", flush=True)
    assert dx < 1e-4, dx
    assert dl < 1e-5, dl


def phase_measure(lib_path, k1_ms: float, timed, timed_b):
    """The kernel-measurement path: K3's SASS, then roofline --probe and
    kernel_probe --dead --live-slots, K3 against its plain version at every
    probe's size, and a K1 trace read back by trace_summary. ``k1_ms`` is
    phase 2's K1 time on its inputs ``timed``. Returns (K3's kernels-line
    row, K1's and K2's measured-rate bounds (ms, by) on ``timed``, K1's on
    the 32 views ``timed_b``)."""
    from skelsplat_tpu_torch.tools import kernel_probe, roofline
    from skelsplat_tpu_torch.tools.timing import cuda_ms

    # the chains were not folded away: one instruction of each kind per
    # step in every unrolled group of 64 (for exp, MUFU is expf's body)
    sass = roofline.sass_opcodes(lib_path)
    need = {"mul": {"FMUL": 64}, "fma": {"FMUL": 64, "FADD": 64},
            "exp": {"MUFU": 64, "FMUL": 64, "FADD": 64},
            "mix": {"FMUL": 192, "FADD": 128, "FSETP": 64}}
    for i, op in enumerate(roofline.OPS):
        for chains in roofline.CHAINS:
            sym = [f for f in sass if f"issue_rate_kernelILi{i}ELi{chains}E" in f]
            assert len(sym) == 1, (op, chains, sym)
            got = sass[sym[0]]
            print(f"  SASS {op}/{chains}: " + ", ".join(
                f"{k} {got[k]}" for k in ("FMUL", "FADD", "FFMA", "FSETP",
                                          "FSEL", "MUFU")), flush=True)
            for opcode, n in need[op].items():
                assert got[opcode] >= n, (op, chains, opcode, got[opcode])

    before = _launches()
    roof = roofline.main(["--probe"])
    probe = kernel_probe.main(["--dead", "--live-slots", *LIVE_SLOTS])
    counts = _launches(since=before)
    print(f"  launches on the measurement path: {counts}", flush=True)
    assert counts["issue_rate"] > 0 and counts["raster_loss_grad"] > 0
    assert counts["raster_loss"] == 0
    assert probe["dead_ms"] < probe["live_ms"], probe

    # the probe's live time against phase 2's, timed apart on inputs that
    # differ only in phase 2's perturbed scales and rotations
    print(f"  K1 live {probe['live_ms']:.4f} ms, dead "
          f"{probe['dead_ms']:.4f} ms (kernel_probe); roofline's K1 "
          f"{roof['k1_ms']:.4f} ms; phase 2 {k1_ms:.4f} ms on perturbed "
          f"scales and rotations: live/phase 2 = "
          f"{probe['live_ms'] / k1_ms:.3f}", flush=True)
    assert abs(probe["live_ms"] / k1_ms - 1) <= 0.10, (probe, k1_ms)
    ms_p, by_p = roof["bound"]["published"]
    ms_m, by_m = roof["bound"]["measured"]
    print(f"  K1 bounds: {ms_p:.6f} ms by {by_p} (published peaks), "
          f"{ms_m:.6f} ms by {by_m} (measured mix rate, expf = "
          f"{roof['bound']['exp_weight']:.2f} mix operations) on "
          f"{roof['card']}", flush=True)
    # the rows' measured-rate bounds, on the inputs whose time they report
    bounds = [roofline.kernel_bound(*x, grad, roof["rates"])["measured"]
              for x, grad in ((timed, True), (timed, False), (timed_b, True))]
    print(f"  measured-rate bounds at phase 2's inputs: K1 "
          f"{bounds[0][0]:.6f} ms by {bounds[0][1]}, K2 {bounds[1][0]:.6f} ms "
          f"by {bounds[1][1]}, K1 on {timed_b[0].shape[0]} views "
          f"{bounds[2][0]:.6f} ms by {bounds[2][1]}", flush=True)

    # K3 against its plain version on each probe's input at its size: the
    # same IEEE operations in the same order, so bitwise equal (mix/1's
    # plain run is also timed)
    k3_err, plain_ms = 0.0, None
    for p in roof["probes"]:
        args = (p["x"], p["k_steps"], p["chains"], p["op"])
        if (p["op"], p["chains"]) == ("mix", 1):
            outs = []
            plain_ms, _ = cuda_ms(
                lambda: outs.append(roofline.issue_rate_plain(*args)),
                reps=1, warmup=0)
            ref, mix = outs[-1], p
        else:
            ref = roofline.issue_rate_plain(*args)
        got = roofline.issue_rate(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), args[1:]
        d = float((got - ref).abs().max())
        assert torch.equal(got, ref), (args[1:], d)
        k3_err = max(k3_err, d)
    print(f"  K3 bitwise equal to plain at every probe's size "
          f"({mix['n']} elements; {sorted({p['k_steps'] for p in roof['probes']})} "
          f"steps)", flush=True)
    n_ops = mix["n"] * mix["k_steps"] * roofline.OPS_PER_STEP["mix"]
    t_bytes = 8 * mix["n"] / roofline.PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / roofline.PEAK_F32_PER_S * 1e3
    print(f"  K3 mix/1 at full size: {mix['ms']:.4f} ms/launch, plain "
          f"{plain_ms:.2f} ms", flush=True)
    trace_k1()
    row = {"name": "issue_rate", "route": "cuda",
           "source": "skelsplat_tpu_torch/csrc/issue_rate.cu",
           "replaces": "skelsplat_tpu/tools/roofline.py:212",
           "launches": counts["issue_rate"], "max_abs_err": k3_err,
           "ms": mix["ms"], "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "library_ms": None}
    return row, *bounds


# K1's two kernels (csrc/raster_loss.cu), as their names appear in a trace
K1_KERNELS = ("live_tiles", "raster_loss_live")


def k1_trace_records(events):
    """(correlation ids of the runtime launches inside K1's wrapper range,
    device records) of a trace. Asserts that every device record is one of
    K1's kernels launched there."""
    from skelsplat_tpu_torch.tools import trace_summary

    k1_launches = trace_summary.range_launches(events,
                                               "skelsplat::raster_loss_grad")
    kernels = trace_summary.device_events(events)
    for ev in kernels:
        assert ev.get("args", {}).get("correlation") in k1_launches and \
            any(k in ev["name"] for k in K1_KERNELS), \
            (ev["name"], ev.get("args"))
    return k1_launches, kernels


def trace_k1():
    """Exports torch.profiler traces of TRACE_LAUNCHES K1 launches (a
    warm-up round, then the traced one, both padded by
    tools/timing.py::profiled_round) and reads each back with
    trace_summary, until one holds every kernel record, for at most
    TRACE_ATTEMPTS traces. Every trace must hold the wrapper's 2 *
    TRACE_LAUNCHES runtime launches (host records) and only K1 kernel
    records launched there. torch.profiler now and then drops the device
    records of a short session, some or all (PERF.md), so a trace may
    hold fewer; in the first that holds them all, ``summarize`` must count
    TRACE_LAUNCHES of each kernel, all attributed to the wrapper's range.
    That trace is kept as build/traces/k1_trace.json, the others beside
    it. Prints the traces that lost records and the spread of kernel
    start minus launch, the profiler's device-to-host clock error."""
    import shutil

    from torch.profiler import ProfilerActivity, profile, schedule

    from skelsplat_tpu_torch.ops import cuda_raster as cr
    from skelsplat_tpu_torch.tools import kernel_probe, trace_summary
    from skelsplat_tpu_torch.tools.timing import (PROFILE_EDGE_S,
                                                  profiled_round)

    pack, p1s, p2s, img = kernel_probe.probe_inputs()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "k1_trace.json"
    lost, offsets = [], []
    for attempt in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                     ) as prof:
            for _ in range(2):
                profiled_round(
                    prof, lambda: cr.raster_loss_grad(pack, p1s, p2s, img,
                                                      False), TRACE_LAUNCHES)
        events = trace_summary.load_trace_events(str(path))
        k1_launches, kernels = k1_trace_records(events)
        assert len(k1_launches) == 2 * TRACE_LAUNCHES, \
            (attempt, len(k1_launches))
        offs = trace_summary.launch_offsets(events)
        if offs:
            offsets.append((min(offs.values()), max(offs.values())))
        if len(kernels) == len(k1_launches):
            break
        lost.append((attempt, len(k1_launches) - len(kernels)))
        shutil.copyfile(path, TRACE_DIR / f"k1_trace_lost_{attempt:02d}.json")
    print(f"  {len(lost) + 1} trace(s) of {2 * TRACE_LAUNCHES} K1 launches "
          f"(rounds padded by {PROFILE_EDGE_S * 1e3:.0f} ms); records lost "
          f"(trace, records): {lost}", flush=True)
    assert len(lost) < TRACE_ATTEMPTS, \
        f"no trace of {TRACE_ATTEMPTS} held every K1 kernel record"
    launch = next(e for e in events if e.get("cat") == "cuda_runtime"
                  and "correlation" in e.get("args", {}))
    print(f"  trace fields: kernel args {sorted(kernels[0].get('args', {}))}"
          f"; runtime {launch['name']!r} args {sorted(launch['args'])}",
          flush=True)
    _, counts, _, n_op = trace_summary.summarize(
        events, top=6, by_op=True, out=lambda r: print(f"    {r}"))
    for kernel in K1_KERNELS:
        names = [k for k in counts if kernel in k]
        assert len(names) == 1 and counts[names[0]] == TRACE_LAUNCHES, \
            (kernel, {k: counts[k] for k in names})
    assert n_op["skelsplat::raster_loss_grad"] == 2 * TRACE_LAUNCHES, n_op
    lows = sorted(lo for lo, _ in offsets)
    print(f"  kernel start minus launch: lowest {lows[0]:.1f} us, highest "
          f"{max(hi for _, hi in offsets):.1f} us", flush=True)


def phase_cli():
    """The CLI sweep over a synthetic H36M tree (phase 6). Returns (K1
    launches in train.main, K2 launches there, s/scene, MPJPE results)."""
    import shutil

    from skelsplat_tpu_torch import eval as eval_cli
    from skelsplat_tpu_torch.data.loader import DataLoader
    from skelsplat_tpu_torch.tools import make_synthetic_dataset

    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    root = SMOKE_DIR / "synth-h36m"   # the loader dispatches on "h36m"
    run_dir = SMOKE_DIR / "run"
    n = make_synthetic_dataset.write_tree(str(root), ["S9", "S11"], 64, 64,
                                          image_size=1000)
    assert n == CLI_SCENES, n
    overrides = [f"dataset.data_root={root}",
                 f"dataset.end_scene_id={CLI_SCENES}"]
    loader = DataLoader(str(root), str(root / "initial_guess" / "metrabs"),
                        str(root / "2d_metrabs"), end_id=CLI_SCENES)
    init_mpjpe = _initial_mpjpe(loader)

    results, counts = _train(["--config-name", "h36m.yaml", *overrides,
                              f"hydra.run.dir={run_dir}"])
    print(f"  train.main: {len(results)} scenes, launches {counts}",
          flush=True)
    assert counts == _step_launches(CLI_SCENES * ITERATIONS // 4), counts

    names = [r["scene_name"] for r in results]
    need = ([run_dir / "point_cloud" / f"iteration_{ITERATIONS}" / f"{s}.ply"
             for s in names]
            + [run_dir / "input.ply", run_dir / "cameras.json",
               run_dir / "train_summary.json"]
            + [run_dir / d / f"{stem}_{v}.png"
               for d, stem in (("images", "render"), ("heatmaps", "heatmap"))
               for v in range(N_VIEWS)])
    missing = [str(p) for p in need if not p.is_file()]
    assert len(names) == CLI_SCENES and not missing, (names, missing)
    summary = json.loads((run_dir / "train_summary.json").read_text())
    for r in summary["scenes"]:
        assert np.isfinite(r["abs_error"]) and np.isfinite(r["rel_error"]), r
        assert r["stopped_at"] == 0, r
    print(f"  logged errors (abs, rel mm): "
          f"{[(round(r['abs_error'], 3), round(r['rel_error'], 3)) for r in summary['scenes']]}",
          flush=True)

    res = eval_cli.main(["--config-name", "h36m.yaml", *overrides,
                         f"eval.output_path={run_dir}"])[ITERATIONS]
    print(f"  eval.main: absolute MPJPE {res['absolute']:.4f} mm, relative "
          f"{res['relative']:.4f} mm; the initial guesses' {init_mpjpe:.4f} "
          f"mm", flush=True)
    assert np.isfinite(res["absolute"]) and np.isfinite(res["relative"]), res
    assert res["absolute"] < init_mpjpe, (res, init_mpjpe)
    return counts, summary["mean_seconds_per_scene"], res


def phase_batch(card: str, profile: bool):
    """The batched sweep against the serial one over a 10-scene synthetic
    H36M tree (phase 7). Returns (K1 launches of the batched train.main,
    the serial and batched summaries)."""
    import math
    import shutil

    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch import eval as eval_cli
    from skelsplat_tpu_torch.core.cameras import stack_cameras
    from skelsplat_tpu_torch.data import ply
    from skelsplat_tpu_torch.data.loader import DataLoader
    from skelsplat_tpu_torch.synthetic import synthetic_inputs
    from skelsplat_tpu_torch.tools import make_synthetic_dataset

    shutil.rmtree(BATCH_DIR, ignore_errors=True)
    root = BATCH_DIR / "synth-h36m"
    n = make_synthetic_dataset.write_tree(str(root), ["S9", "S11"], 192, 64,
                                          image_size=1000)
    assert n >= BATCH_SCENES, n
    overrides = [f"dataset.data_root={root}",
                 f"dataset.end_scene_id={BATCH_SCENES}"]
    loader = DataLoader(str(root), str(root / "initial_guess" / "metrabs"),
                        str(root / "2d_metrabs"), end_id=BATCH_SCENES)
    init_mpjpe = _initial_mpjpe(loader)

    runs = {}
    for batch in (1, SCENE_BATCH):
        run_dir = BATCH_DIR / f"run_b{batch}"
        results, counts = _train([
            "--config-name", "h36m.yaml", *overrides,
            "debug.save_images=false", f"training.scene_batch={batch}",
            f"hydra.run.dir={run_dir}"])
        groups = math.ceil(BATCH_SCENES / batch)
        print(f"  train.main, scene_batch={batch}: {len(results)} scenes, "
              f"launches {counts} ({groups} groups)", flush=True)
        assert counts == _step_launches(groups * ITERATIONS // 4), counts
        names = [r["scene_name"] for r in results]
        plys = [run_dir / "point_cloud" / f"iteration_{ITERATIONS}"
                / f"{s}.ply" for s in names]
        missing = [str(p) for p in plys if not p.is_file()]
        assert len(names) == BATCH_SCENES and not missing, (names, missing)
        summary = json.loads((run_dir / "train_summary.json").read_text())
        res = eval_cli.main(["--config-name", "h36m.yaml", *overrides,
                             f"eval.output_path={run_dir}"])[ITERATIONS]
        print(f"  eval.main: absolute MPJPE {res['absolute']:.4f} mm, "
              f"relative {res['relative']:.4f} mm", flush=True)
        assert np.isfinite(res["absolute"]) and np.isfinite(res["relative"])
        runs[batch] = (counts, summary, res,
                       {s: ply.read_xyz(str(p)) for s, p in zip(names, plys)})

    (_, serial, res_1, xyz_1), (counts, batched, res_b, xyz_b) = \
        runs[1], runs[SCENE_BATCH]
    assert "wall_seconds_per_scene" in batched and "pipelined_scenes" in serial
    d_err = max(abs(a["abs_error"] - b["abs_error"])
                for a, b in zip(serial["scenes"], batched["scenes"]))
    d_xyz = max(float(np.abs(xyz_b[s] - xyz_1[s]).max()) for s in xyz_1)
    bitwise = all(np.array_equal(xyz_b[s], xyz_1[s]) for s in xyz_1)
    print(f"  batched vs serial: largest per-scene |Δ abs_error| {d_err:.3g} "
          f"mm, |Δ MPJPE| {abs(res_b['absolute'] - res_1['absolute']):.3g} "
          f"mm, largest per-scene |Δxyz| {d_xyz:.3g} mm (bitwise equal: "
          f"{bitwise}); the initial guesses' MPJPE {init_mpjpe:.4f} mm",
          flush=True)
    assert all(a["scene_name"] == b["scene_name"] and b["stopped_at"] == 0
               for a, b in zip(serial["scenes"], batched["scenes"]))
    assert d_err <= BATCH_ATOL_MM, d_err
    assert abs(res_b["absolute"] - res_1["absolute"]) <= BATCH_ATOL_MM
    assert res_b["absolute"] < init_mpjpe, (res_b, init_mpjpe)
    # one full batch alone, through a host copy of xyz, as phase 3 times a
    # frame (the sweep's per-scene "seconds" overlap the next batch)
    init, gt, p2d, cams_np = synthetic_inputs(SCENE_BATCH, W, H,
                                              n_views=N_VIEWS, seed=0)
    cams_b = stack_cameras([compat.camera_from_numpy(cams_np, device="cpu")]
                           * SCENE_BATCH)
    trainer = make_trainer(ITERATIONS, "cuda")

    def run_batch():
        return trainer.optimize_scene_batch(init, p2d, cams_b, gt, lean=True)

    times = []
    for _ in range(TIMED_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, _ = run_batch()
        xyz = params.xyz.cpu().numpy()
        times.append(time.perf_counter() - t0)
        assert np.isfinite(xyz).all()
    s_per_batch = float(np.median(times))
    print(f"  serial {serial['mean_seconds_per_scene']:.6f} s/scene "
          f"(mean_seconds_per_scene); batched "
          f"{batched['wall_seconds_per_scene']:.6f} s/scene "
          f"(wall_seconds_per_scene), a full batch's scenes "
          f"{batched['scenes'][0]['seconds']:.6f} s/scene (enqueue to "
          f"result, overlapping the next batch); {BATCH_SCENES} scenes, "
          f"{ITERATIONS} iterations, 4 views at {W}x{H}, on {card}",
          flush=True)
    print(f"  one batch of {SCENE_BATCH} frames alone: "
          f"{[round(t, 6) for t in times]} s, {s_per_batch / SCENE_BATCH:.6f} "
          f"s/scene (median) on {card}", flush=True)
    if profile:
        profile_run(run_batch, s_per_batch, f"batch of {SCENE_BATCH} frames")
    return counts, serial, batched


def _train(args):
    """train.main in-process, with the kernel launches it makes counted.
    Returns (summary dicts, counts)."""
    from skelsplat_tpu_torch import train as train_cli

    stdout = sys.stdout   # train.main's safe_state replaces it
    before = _launches()
    try:
        results = train_cli.main(args)
        torch.cuda.synchronize()
    finally:
        sys.stdout = stdout
    return results, _launches(since=before)


def _initial_mpjpe(loader) -> float:
    return float(np.mean([
        np.linalg.norm(r.pose_3d - r.pose_3d_gt, axis=1).mean()
        for _, r in loader]))


def _loader(cfg, end_id: int):
    import os

    from skelsplat_tpu_torch.data.loader import DataLoader

    d = cfg.dataset
    return DataLoader(d.data_root, os.path.join(d.data_root, "initial_guess",
                                                d.initial_guess),
                      os.path.join(d.data_root, "2d_" + d.poses_2d),
                      frame_step=d.frame_step, end_id=end_id,
                      nviews=d.nviews)


def check_k1_at(name, width: int, height: int, n_joints: int):
    """K1 against its plain version on the card at a sweep's (N, W, H), and
    its time, plain time and bound there. Returns the K1 row's fields for
    ``name`` and the largest |difference|."""
    from skelsplat_tpu_torch.ops import cuda_raster as cr
    from skelsplat_tpu_torch.tools import kernel_probe
    from skelsplat_tpu_torch.tools.roofline import kernel_bound
    from skelsplat_tpu_torch.tools.timing import cuda_ms

    x = kernel_probe.probe_inputs(width, height, n_joints=n_joints,
                                  n_views=N_VIEWS, device="cuda",
                                  perturb=True)
    S, C, dg, live = cr.raster_loss_grad(*x, False, return_live=True)
    Sp, Cp, dgp = cr.raster_loss_grad_plain(*x, False)
    torch.cuda.synchronize()
    check_live_list(f"K1 at {name}", live, cr.live_tiles_plain(x[0], height,
                                                               width))
    assert torch.equal(C, Cp) and bool((C > 0).all()), (C, Cp)
    torch.testing.assert_close(S, Sp, rtol=1e-5, atol=0)
    rel = dg_rel_err(dg, dgp)
    assert float(rel.max()) <= DG_RTOL, (name, rel.tolist())
    ms, stream_ms = cuda_ms(lambda: cr.raster_loss_grad(*x, False), reps=200,
                            each_kernel_once=True)
    plain_ms, _ = cuda_ms(lambda: cr.raster_loss_grad_plain(*x, False),
                          reps=2, warmup=1)
    b_ms, b_by = kernel_bound(*x, True)["published"]
    err = max(float((dg - dgp).abs().max()), float((S - Sp).abs().max()))
    print(f"  K1 at {name} ({N_VIEWS} views, {n_joints} joints, "
          f"{width}x{height}): C exact, dg rel err per component "
          f"{[float(f'{r:.3g}') for r in rel.tolist()]}; {ms:.4f} ms/call "
          f"device time ({stream_ms:.4f} back to back), plain {plain_ms:.2f} "
          f"ms, bound {b_ms:.6f} ms by {b_by}", flush=True)
    return {f"ms_{name}": ms, f"plain_ms_{name}": plain_ms,
            f"bound_ms_{name}": b_ms, f"bound_by_{name}": b_by}, err


def sweep_dataset(config: str, size, n_joints: int, card: str):
    """Phase 8 (a)/(b): a synthetic tree of ``config``'s layout at its
    cameras' own size, trained by train.main and scored by eval.main.
    Returns (K1 launches, run dir, root, s/scene, MPJPE)."""
    from skelsplat_tpu_torch import eval as eval_cli
    from skelsplat_tpu_torch.config import load_config
    from skelsplat_tpu_torch.data import cameras_io
    from skelsplat_tpu_torch.tools import make_synthetic_dataset as synth

    root = OPTION_DIR / f"synth-{config}"   # the loader dispatches on it
    run_dir = OPTION_DIR / f"run-{config}"
    if config == "panoptic":
        n = synth.write_panoptic_tree(str(root), activities=("171204_pose5",),
                                      frames=DATASET_SCENES, image_size=size)
    else:
        n = synth.write_occlusion_person_tree(str(root), frames=DATASET_SCENES,
                                              image_size=size)
    assert n == DATASET_SCENES, n
    overrides = [f"dataset.data_root={root}",
                 f"dataset.end_scene_id={DATASET_SCENES}"]
    loader = _loader(load_config(f"{config}.yaml", overrides,
                                 make_run_dir=False), DATASET_SCENES)
    for _, rec in loader:
        cams = cameras_io.build_camera_batch(rec.cameras, device="cpu")
        assert rec.pose_3d.shape == (n_joints, 3), rec.pose_3d.shape
        assert {int(w) for w in cams.width} == {size[0]} and \
            {int(h) for h in cams.height} == {size[1]}, (cams.width,
                                                         cams.height)
    init_mpjpe = _initial_mpjpe(loader)
    results, counts = _train(["--config-name", f"{config}.yaml", *overrides,
                              f"hydra.run.dir={run_dir}"])
    print(f"  train.main, {config}.yaml: {len(results)} scenes, launches "
          f"{counts}", flush=True)
    assert counts == _step_launches(DATASET_SCENES * ITERATIONS // 4), counts
    missing = [r["scene_name"] for r in results if not (
        run_dir / "point_cloud" / f"iteration_{ITERATIONS}"
        / f"{r['scene_name']}.ply").is_file()]
    assert len(results) == DATASET_SCENES and not missing, missing
    summary = json.loads((run_dir / "train_summary.json").read_text())
    res = eval_cli.main(["--config-name", f"{config}.yaml", *overrides,
                         f"eval.output_path={run_dir}"])[ITERATIONS]
    s_scene = summary["mean_seconds_per_scene"]
    print(f"  {config}: absolute MPJPE {res['absolute']:.4f} mm, relative "
          f"{res['relative']:.4f} mm; the initial guesses' {init_mpjpe:.4f} "
          f"mm; {s_scene:.6f} s/scene (mean_seconds_per_scene; "
          f"{DATASET_SCENES} scenes, {ITERATIONS} iterations, {N_VIEWS} views "
          f"at {size[0]}x{size[1]}, {n_joints} joints) on {card}", flush=True)
    assert np.isfinite(res["absolute"]) and np.isfinite(res["relative"])
    assert res["absolute"] < init_mpjpe, (res, init_mpjpe)
    return counts["raster_loss_grad"], run_dir, root, s_scene, res


def dense_card_vs_cpu(root):
    """Each view's dense soft-argmax loss and xyz gradient at the initial
    parameters of the tree's first scene, on the card and on the CPU."""
    from skelsplat_tpu_torch.config import load_config
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.data import cameras_io
    from skelsplat_tpu_torch.engine import driver
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer

    cfg = load_config("h36m.yaml", [
        f"dataset.data_root={root}",
        f"training.loss_function={SOFTARGMAX_LOSS}"], make_run_dir=False)
    _, rec = next(iter(_loader(cfg, 1)))
    m = cfg.model
    model = SkeletonModel("h36m", 17, scaling=float(m.scaling),
                          scaling_modifier=float(m.scaling_modifier),
                          opacity_on=bool(m.opacity_on))
    cams = cameras_io.build_camera_batch(rec.cameras, device="cpu")
    W_, H_ = int(cams.width.max()), int(cams.height.max())
    out = {}
    for dev in ("cuda", "cpu"):
        t = SceneTrainer(model, driver.opt_config_from(cfg.optimization),
                         driver.train_settings_from(cfg.training), W_, H_,
                         device=dev)
        assert t.renderer == "dense", t.renderer
        init, p2d, _, _, drop, _ = t.host_inputs(rec.pose_3d, rec.poses_2d,
                                                 cams)
        c = cams.map(lambda x: x.to(dev))
        p2d = torch.as_tensor(p2d, device=dev)
        params, aux = t._prepare(init, p2d, c, torch.as_tensor(drop,
                                                               device=dev))
        losses, grads = t._per_view_grads(params, c, aux, p2d, N_VIEWS)
        out[dev] = (losses.cpu(), grads.xyz.cpu())
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    loss_rel = float((lg / lc - 1).abs().max())
    grad_rel = float(((gg - gc).abs().amax(dim=(1, 2))
                      / gc.abs().amax(dim=(1, 2))).max())
    print(f"  dense {SOFTARGMAX_LOSS} at the initial parameters, card vs "
          f"CPU: per-view loss rel diff {loss_rel:.3g} (losses "
          f"{lg.tolist()}), xyz gradient diff {grad_rel:.3g} of each view's "
          f"largest |component|", flush=True)
    assert loss_rel <= 1e-5, loss_rel
    assert grad_rel <= DENSE_GRAD_RTOL, grad_rel
    return loss_rel, grad_rel


def phase_options(card: str):
    """Phase 8. Returns the K1 row's new fields, the largest |K1 − plain|
    of its checks and the dense soft-argmax scene's MPJPE."""
    import shutil

    from skelsplat_tpu_torch import eval as eval_cli
    from skelsplat_tpu_torch import render as render_cli
    from skelsplat_tpu_torch import triangulation as tri_cli
    from skelsplat_tpu_torch.data import ply

    shutil.rmtree(OPTION_DIR, ignore_errors=True)
    row, err, runs = {}, 0.0, {}
    for config, size, n_joints in DATASETS:
        key = config.replace("-", "_")
        launches, run_dir, root, _, _ = sweep_dataset(config, size, n_joints,
                                                      card)
        runs[config] = (run_dir, root)
        row[f"launches_{key}"] = launches
        fields, e = check_k1_at(key, *size, n_joints)
        row.update(fields)
        err = max(err, e)

    # (c) the dense soft-argmax path, over phase 6's H36M tree
    h36m = SMOKE_DIR / "synth-h36m"
    one = [f"dataset.data_root={h36m}", "dataset.end_scene_id=1"]
    run_dir = OPTION_DIR / "run-dense"
    torch.cuda.reset_peak_memory_stats()
    results, counts = _train(["--config-name", "h36m.yaml", *one,
                              f"training.loss_function={SOFTARGMAX_LOSS}",
                              "debug.save_images=false",
                              f"hydra.run.dir={run_dir}"])
    peak = torch.cuda.max_memory_allocated()
    summary = json.loads((run_dir / "train_summary.json").read_text())
    res = eval_cli.main(["--config-name", "h36m.yaml", *one,
                         f"eval.output_path={run_dir}"])[ITERATIONS]
    print(f"  dense {SOFTARGMAX_LOSS}: launches {counts}; peak device memory "
          f"{peak} bytes (torch.cuda.max_memory_allocated); "
          f"{summary['mean_seconds_per_scene']:.6f} s/scene; absolute MPJPE "
          f"{res['absolute']:.4f} mm; 1 scene, {ITERATIONS} iterations, "
          f"{N_VIEWS} views at {W}x{H}, on {card}", flush=True)
    assert counts == _step_launches(0, ITERATIONS // 4), counts
    assert len(results) == 1 and np.isfinite(res["absolute"]), res
    dense_mpjpe = res["absolute"]
    dense_card_vs_cpu(h36m)

    # (d) confidence-weighted fusion through K1
    run_dir = OPTION_DIR / "run-fusion"
    results, counts = _train(["--config-name", "h36m.yaml", *one,
                              "+training.view_fusion=confidence_weighted",
                              "debug.save_images=false",
                              f"hydra.run.dir={run_dir}"])
    res = eval_cli.main(["--config-name", "h36m.yaml", *one,
                         f"eval.output_path={run_dir}"])[ITERATIONS]
    print(f"  view_fusion=confidence_weighted: launches {counts}; absolute "
          f"MPJPE {res['absolute']:.4f} mm, relative {res['relative']:.4f} "
          f"mm", flush=True)
    assert counts == _step_launches(ITERATIONS // 4, 0), counts
    assert np.isfinite(res["absolute"]), res
    row["launches_fusion"] = counts["raster_loss_grad"]

    # (e) triangulation over (a)'s tree, card against CPU
    assert DATASETS[0][0] == "panoptic"
    pan_run, pan_root = runs["panoptic"]
    tri = ["--config-name", "triangulation.yaml",
           f"dataset.data_root={pan_root}"]
    stdout = sys.stdout
    try:
        gpu_dir = Path(tri_cli.main([*tri, f"hydra.run.dir={OPTION_DIR / 'tri-gpu'}"]))
        cpu_dir = Path(tri_cli.main(["--device", "cpu", *tri,
                                     f"hydra.run.dir={OPTION_DIR / 'tri-cpu'}"]))
    finally:
        sys.stdout = stdout
    names = sorted(p.name for p in (gpu_dir / "point_cloud" /
                                    "iteration_0").iterdir())
    assert len(names) == DATASET_SCENES, names
    rel = 0.0
    for name in names:
        g, c = (ply.read_xyz(str(d / "point_cloud" / "iteration_0" / name))
                for d in (gpu_dir, cpu_dir))
        rel = max(rel, float(np.abs(g - c).max() / np.abs(c).max()))
    print(f"  triangulation on the card vs the CPU: {len(names)} clouds, "
          f"largest |difference| {rel:.3g} of the largest |coordinate|",
          flush=True)
    assert rel <= TRI_REL, rel

    # (f) render over (a)'s run
    out = Path(render_cli.main([
        "--config-name", "panoptic.yaml", f"dataset.data_root={pan_root}",
        f"dataset.end_scene_id={DATASET_SCENES}",
        f"eval.output_path={pan_run}", f"render.iteration={ITERATIONS}"]))
    pngs = sorted(out.glob("*.png"))
    assert len(pngs) == N_VIEWS * DATASET_SCENES, pngs
    from PIL import Image

    pan_w, pan_h = DATASETS[0][1]
    for p in pngs:
        im = np.asarray(Image.open(p))
        assert im.shape == (pan_h, pan_w) and im.max() == 255, (p, im.shape)
    print(f"  render: {len(pngs)} PNGs of {pan_w}x{pan_h} under {out}",
          flush=True)
    return row, err, dense_mpjpe


def _image_metrics_card_vs_cpu(cfg, run_dir, weights, card_scene):
    """Phase 9 (a): one scene's image metrics on the CPU against the
    card's. Returns (|dSSIM|, LPIPS relative difference)."""
    from skelsplat_tpu_torch.evaluation import image_metrics

    cpu = image_metrics(_loader(cfg, 1), str(run_dir),
                        scaling=float(cfg.model.scaling),
                        scaling_modifier=float(cfg.model.scaling_modifier),
                        lpips_weights=weights, print_fn=lambda *_: None,
                        device="cpu")["per_scene"]
    (name, c), = cpu.items()
    g = card_scene[name]
    d_ssim = abs(g["ssim"] - c["ssim"])
    d_lpips = abs(g["lpips"] - c["lpips"]) / abs(c["lpips"])
    print(f"  card vs CPU on {name}: SSIM {g['ssim']:.9f} vs "
          f"{c['ssim']:.9f} (|d| {d_ssim:.3g}, bar {SSIM_ATOL:g}); LPIPS "
          f"{g['lpips']:.9f} vs {c['lpips']:.9f} (relative {d_lpips:.3g}, "
          f"bar {LPIPS_RTOL:g})", flush=True)
    assert d_ssim <= SSIM_ATOL and d_lpips <= LPIPS_RTOL, (g, c)
    return d_ssim, d_lpips


def _time_lpips(cfg, run_dir, weights, card: str):
    """Phase 9 (a): LPIPS alone on one scene's 4 views, by CUDA events,
    and its peak device memory."""
    from skelsplat_tpu_torch.core.gaussians import scene_type_of
    from skelsplat_tpu_torch.evaluation import (_scene_plys, lpips_inputs,
                                                scene_images)
    from skelsplat_tpu_torch.ops.lpips import LPIPS
    from skelsplat_tpu_torch.tools.timing import cuda_ms

    _, rec = next(iter(_loader(cfg, 1)))
    model = LPIPS.from_npz(weights)
    with torch.no_grad():
        a, b = lpips_inputs(*scene_images(
            rec, _scene_plys(str(run_dir))[rec.scene_name],
            scene_type_of(cfg.dataset.data_root),
            float(cfg.model.scaling), float(cfg.model.scaling_modifier),
            model.mean.device))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        device_ms, ms = cuda_ms(lambda: model(a, b), 5, warmup=1)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"  LPIPS (vgg) on one scene's {a.shape[0]} views of "
          f"{a.shape[3]}x{a.shape[2]}: {ms:.4f} ms (CUDA events, mean of 5 "
          f"after a warm-up), kernels {device_ms:.4f} ms; peak {peak} bytes "
          f"above its inputs (torch.cuda.max_memory_allocated), on {card}",
          flush=True)
    return ms, device_ms, peak


def _read_clouds(card: str):
    """Phase 9 (c): the native codec's bulk read of phase 6's and 7's
    result clouds against the numpy reader, bitwise, and both times."""
    from skelsplat_tpu_torch import native
    from skelsplat_tpu_torch.data import ply

    paths = sorted(str(p) for d in (SMOKE_DIR / "run", BATCH_DIR)
                   for p in d.rglob("point_cloud/iteration_*/*.ply"))
    out, counts = native.read_xyz_batch(paths, max_pts=64)
    ref = [ply.read_xyz(p) for p in paths]
    for i, r in enumerate(ref):
        assert counts[i] == r.shape[0], (paths[i], counts[i])
        assert np.array_equal(out[i, :counts[i]], r.astype(np.float32)), \
            paths[i]
    times = {}
    for name, fn in (("codec", lambda: native.read_xyz_batch(paths)),
                     ("numpy", lambda: [ply.read_xyz(p) for p in paths])):
        fn()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        times[name] = (time.perf_counter() - t0) / 5 * 1e3
    print(f"  codec bulk read of {len(paths)} clouds bitwise equal to the "
          f"numpy reader; codec {times['codec']:.3f} ms, numpy "
          f"{times['numpy']:.3f} ms (host clock, mean of 5 after one)",
          flush=True)
    return len(paths), times


def _gaussian_model(cfg):
    """Phase 9 (d): the upstream-3DGS object API on the card, from a
    Scene through Adam steps, densification, the opacity reset and a PLY
    round trip."""
    import types

    from skelsplat_tpu_torch import compat, renderer_registry
    from skelsplat_tpu_torch.core.gaussians import (PARAM_FIELDS, init_params,
                                                    scene_type_of)
    from skelsplat_tpu_torch.data.camera_utils import loadCam
    from skelsplat_tpu_torch.ops import densify

    _, rec = next(iter(_loader(cfg, 1)))
    out_dir = EXTRAS_DIR / "compat"
    g = compat.GaussianModel()
    scene = compat.Scene(cfg.dataset, cfg.model, g, rec.pose_3d, rec.cameras,
                         rec.scene_name, str(out_dir))
    g.training_setup(cfg.optimization)
    render = renderer_registry.render_functions[cfg.pipeline.rendering]
    cam = loadCam(types.SimpleNamespace(resolution=-1), 0, rec.cameras[0],
                  1.0, device=g.device)
    with torch.no_grad():
        target = render(cam, init_params(
            rec.pose_3d_gt, scene_type_of(cfg.dataset.data_root),
            float(cfg.model.scaling), float(cfg.model.scaling_modifier),
            device=g.device))["render"]
    losses = []
    for it in range(1, COMPAT_STEPS + 1):
        leaves = [getattr(g.params, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS]
        out = render(cam, type(g.params)(*leaves))
        loss = torch.mean((out["render"] - target) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        g.step(type(g.params)(*grads), it)
        losses.append(float(loss.detach()))
    n = g.params.n_joints
    aux = densify.add_densification_stats(
        densify.DensifyAux.zeros(n), grads[0], out["radii"],
        out["visibility_filter"])
    params, state, aux = densify.densify_and_prune(
        g.params, g.opt_state, aux, max_grad=0.0, min_opacity=0.005,
        extent=scene.cameras_extent, max_screen_size=None,
        radii=out["radii"])
    n2 = params.n_joints
    assert n2 >= n and aux.denom.shape == (n2, 1), (n, n2)
    for f in PARAM_FIELDS:
        for t in (getattr(params, f), getattr(state.m, f),
                  getattr(state.v, f)):
            assert t.shape[0] == n2, (f, t.shape)
            assert t.device.type == g.device.type, (f, t.device)
    params, state = densify.reset_opacity(params, state)
    assert float(torch.sigmoid(params.opacity_logit).max()) <= 0.01 + 1e-6
    g.params, g.opt_state = params, state
    scene.save(COMPAT_STEPS)
    g2 = compat.GaussianModel()
    g2.load_ply(str(out_dir / "point_cloud" / f"iteration_{COMPAT_STEPS}"
                    / "point_cloud.ply"))
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(g2.params, f), getattr(params, f)), f
    print(f"  GaussianModel: Scene of {n} joints, {COMPAT_STEPS} Adam steps "
          f"(loss {losses[0]:.6g} -> {losses[-1]:.6g}), densify_and_prune "
          f"{n} -> {n2} Gaussians, reset_opacity, PLY round trip equal",
          flush=True)
    return n2


def phase_extras(card: str):
    """Phase 9: the eval extras and the compatibility surface on the card.
    Returns the phase's numbers."""
    import shutil

    from skelsplat_tpu_torch import eval as eval_cli
    from skelsplat_tpu_torch.config import load_config
    from skelsplat_tpu_torch.ops import lpips
    from skelsplat_tpu_torch.tools import bench_ssim

    shutil.rmtree(EXTRAS_DIR, ignore_errors=True)
    EXTRAS_DIR.mkdir(parents=True)
    root, run_dir = SMOKE_DIR / "synth-h36m", SMOKE_DIR / "run"
    weights = str(EXTRAS_DIR / "vgg.npz")
    lpips.save_npz(weights, lpips.random_weights("vgg", seed=0), "vgg")
    overrides = [f"dataset.data_root={root}",
                 f"dataset.end_scene_id={CLI_SCENES}"]
    cfg = load_config("h36m.yaml", overrides, make_run_dir=False)

    # (a) eval.image_metrics=true over phase 6's run
    before = _launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = eval_cli.main(["--config-name", "h36m.yaml", *overrides,
                         f"eval.output_path={run_dir}",
                         "eval.image_metrics=true",
                         f"eval.lpips_weights={weights}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    im = res["image_metrics"]
    print(f"  eval.main with image_metrics: SSIM {im['ssim']:.6f}, LPIPS "
          f"(vgg, random weights seed 0) {im['lpips']:.6f} over "
          f"{len(im['per_scene'])} scenes; {seconds / CLI_SCENES:.6f} s/scene "
          f"(host clock, MPJPE included); peak device memory {peak} bytes; "
          f"launches {_launches(since=before)}; on {card}", flush=True)
    assert len(im["per_scene"]) == CLI_SCENES, im
    assert 0.0 < im["ssim"] < 1.0 and im["lpips"] > 0.0, im
    assert all(np.isfinite([e["ssim"], e["lpips"]]).all()
               for e in im["per_scene"].values()), im
    assert not any(_launches(since=before).values()), \
        _launches(since=before)
    d_ssim, d_lpips = _image_metrics_card_vs_cpu(cfg, run_dir, weights,
                                                 im["per_scene"])
    lpips_ms, lpips_device_ms, lpips_peak = _time_lpips(cfg, run_dir,
                                                        weights, card)

    # (b) SSIM at the JAX tool's default shape
    bench = bench_ssim.main(["--shape", *SSIM_SHAPE])
    assert bench["grad_max_abs_err"] <= bench_ssim.GRAD_ATOL, bench
    print(f"  bench_ssim at {'x'.join(SSIM_SHAPE)} on {card}", flush=True)

    # (c) the native codec
    n_clouds, read_ms = _read_clouds(card)

    # (d) GaussianModel
    n_gaussians = _gaussian_model(cfg)
    return {"ssim": im["ssim"], "lpips": im["lpips"],
            "s_per_scene": seconds / CLI_SCENES, "peak_bytes": peak,
            "ssim_card_vs_cpu": d_ssim, "lpips_card_vs_cpu": d_lpips,
            "lpips_ms": lpips_ms, "lpips_device_ms": lpips_device_ms,
            "lpips_peak_bytes": lpips_peak,
            "bench_ssim": bench, "clouds": n_clouds, "read_ms": read_ms,
            "densified_to": n_gaussians}


def _mesh_vs_batch(card: str):
    """Phase 10 (a): multichip_optimize on a (1,1) mesh of one NCCL rank
    against optimize_scene_batch of the same scenes. Returns K1's
    launches in the mesh run."""
    import os

    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch.core.cameras import stack_cameras
    from skelsplat_tpu_torch.parallel import launch
    from skelsplat_tpu_torch.parallel.mesh import (make_mesh,
                                                   multichip_optimize)
    from skelsplat_tpu_torch.synthetic import synthetic_inputs

    init, gt, p2d, cams_np = synthetic_inputs(
        MULTICHIP_SCENES, W, H, n_views=N_VIEWS, seed=1,
        widths=MIXED_WIDTHS)
    cams_b = stack_cameras([compat.camera_from_numpy(cams_np, device="cpu")]
                           * MULTICHIP_SCENES)
    trainer = make_trainer(ITERATIONS, "cuda")
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(launch.free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with launch.process_group("cuda") as dev:
            backend = torch.distributed.get_backend()
            mesh = make_mesh(1, 1, device_type=dev.type)
            multichip_optimize(mesh, trainer, init, p2d, cams_b, gt)  # warm
            torch.cuda.synchronize()
            before = _launches()
            t0 = time.perf_counter()
            params, hist = multichip_optimize(mesh, trainer, init, p2d,
                                              cams_b, gt)
            xyz = params.xyz.cpu().numpy()
            dt = time.perf_counter() - t0
            counts = _launches(since=before)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"  (a) multichip_optimize, mesh (1,1) on {backend}: launches "
          f"{counts}; {dt / MULTICHIP_SCENES:.6f} s/scene ({MULTICHIP_SCENES}"
          f" scenes, {ITERATIONS} iterations, 4 views at {W}x{H}) on {card}",
          flush=True)
    assert backend == "nccl", backend
    assert counts == _step_launches(ITERATIONS // 4), counts
    pb, hb = trainer.optimize_scene_batch(init, p2d, cams_b, gt)
    assert np.isfinite(xyz).all()
    assert np.array_equal(xyz, pb.xyz.cpu().numpy())
    for f in ("losses", "error", "error_rel", "stopped_at"):
        assert torch.equal(getattr(hist, f), getattr(hb, f)), f
    print("  (a) each scene's xyz and history bitwise equal to "
          "optimize_scene_batch", flush=True)
    return counts["raster_loss_grad"]


def phase_multichip(card: str, cli_res, cli_s_per_scene: float):
    """Phase 10: the mesh path. Returns (K1 launches of (a), the phase's
    numbers)."""
    import shutil

    from skelsplat_tpu_torch import eval as eval_cli
    from skelsplat_tpu_torch import train as train_cli
    from skelsplat_tpu_torch.data import ply
    from skelsplat_tpu_torch.parallel import launch
    from skelsplat_tpu_torch.parallel.dryrun import dryrun_multichip
    from skelsplat_tpu_torch.tools import parity_study

    shutil.rmtree(MULTICHIP_DIR, ignore_errors=True)
    launches = _mesh_vs_batch(card)

    # (b) the CLI on two ranks sharing the card, over phase 6's tree
    root = SMOKE_DIR / "synth-h36m"
    run_dir, ranks = MULTICHIP_DIR / "run", MULTICHIP_DIR / "ranks"
    overrides = [f"dataset.data_root={root}",
                 f"dataset.end_scene_id={CLI_SCENES}"]
    t0 = time.perf_counter()
    launch.spawn(2, train_cli.main,
                 ["--config-name", "h36m.yaml", *overrides,
                  "training.multichip=true", f"hydra.run.dir={run_dir}"],
                 rank_dir=str(ranks))
    wall = time.perf_counter() - t0
    assert (ranks / "rank1.stdout").read_text() == "", "rank 1 printed"
    summary = json.loads((run_dir / "train_summary.json").read_text())
    assert set(summary) == {"scenes", "mean_seconds_per_scene"}, summary
    serial = SMOKE_DIR / "run" / "point_cloud" / f"iteration_{ITERATIONS}"
    mesh_pc = run_dir / "point_cloud" / f"iteration_{ITERATIONS}"
    names = sorted(p.name for p in serial.glob("*.ply"))
    assert names and names == sorted(p.name for p in mesh_pc.glob("*.ply"))
    d_xyz = max(float(np.abs(ply.read_xyz(str(mesh_pc / n))
                             - ply.read_xyz(str(serial / n))).max())
                for n in names)
    bitwise = all(np.array_equal(ply.read_xyz(str(mesh_pc / n)),
                                 ply.read_xyz(str(serial / n)))
                  for n in names)
    res = eval_cli.main(["--config-name", "h36m.yaml", *overrides,
                         f"eval.output_path={run_dir}"])[ITERATIONS]
    d_mpjpe = abs(res["absolute"] - cli_res["absolute"])
    s_mesh = summary["mean_seconds_per_scene"]
    print(f"  (b) train.main on 2 ranks (backend "
          f"{launch.backend_for('cuda', 2)}, mesh (1,2)): {len(names)} "
          f"scenes; largest |dxyz| against phase 6 {d_xyz:.3g} mm (bitwise "
          f"equal: {bitwise}); MPJPE {res['absolute']:.4f} mm against phase "
          f"6's {cli_res['absolute']:.4f} (|d| {d_mpjpe:.3g} mm); "
          f"{s_mesh:.6f} s/scene (mean_seconds_per_scene) against phase 6's "
          f"{cli_s_per_scene:.6f}, {wall:.1f} s for the 2-rank command with "
          f"its start, on {card}", flush=True)
    assert d_xyz <= MULTICHIP_ATOL_MM and d_mpjpe <= MULTICHIP_ATOL_MM

    # (c) the dry run on the card
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device="cuda")
    print(f"  (c) dryrun_multichip(2) on the card: {json.dumps(dry)}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (d) the renderers through a full optimization
    t0 = time.perf_counter()
    report = parity_study.main(["--scenes", str(MULTICHIP_SCENES),
                                "--preset", "h36m", "--device", "cuda",
                                "--out", str(MULTICHIP_DIR / "parity")])
    worst = max(r["max_disagreement_mm"] for r in report["pairs"].values())
    print(f"  (d) parity_study, {MULTICHIP_SCENES} scenes at the h36m "
          f"preset: largest pairwise disagreement {worst:.6g} mm "
          f"({json.dumps(report['pairs'])}); s per renderer "
          f"{ {k: round(v['seconds'], 3) for k, v in report['renderers'].items()} }"
          f", {time.perf_counter() - t0:.1f} s", flush=True)
    assert np.isfinite(worst) and worst <= PARITY_MM, report["pairs"]
    return launches, {"mesh_s_per_scene": s_mesh,
                      "serial_s_per_scene": cli_s_per_scene,
                      "cli_d_xyz_mm": d_xyz, "cli_d_mpjpe_mm": d_mpjpe,
                      "dryrun": dry, "parity_worst_mm": worst}


def _fusion_inputs(root):
    """Phase 11 (b): per-camera monocular 3D predictions and 2D detections
    beside phase 6's tree's GT, as a user's detectors would leave them.
    Returns the mean single-camera MPJPE (mm)."""
    import shutil

    from skelsplat_tpu_torch.data.cameras_io import H36M_CAMERAS

    rng = np.random.default_rng(0)
    shutil.copytree(root / "initial_guess" / "cameras",
                    root / "3d_gt" / "cameras")
    errs = []
    for act_dir in sorted((root / "initial_guess" / "metrabs").glob("*/*")):
        subject, act = act_dir.parent.name, act_dir.name
        gt = np.load(root / "3d_gt" / subject / act / "poses.npz")[
            "poses"][::64]
        for cam in H36M_CAMERAS:
            mono = (gt + rng.normal(0, MONO_SIGMA_MM, gt.shape)
                    + rng.normal(0, MONO_SIGMA_MM, 3))
            errs.append(np.linalg.norm(mono - gt, axis=-1).mean(axis=-1))
            for tree, key, arr in (
                    ("3d_metrabs_mono", "poses3d", mono),
                    ("2d_resnet", "poses2d", np.load(
                        root / "2d_metrabs" / subject / act / cam
                        / "poses.npz")["poses"])):
                d = root / tree / subject / act / cam
                d.mkdir(parents=True)
                np.savez(d / "poses.npz", **{key: arr})
    return float(np.mean(np.concatenate(errs)))


def _test_set_inputs(root):
    """Phase 11 (a): the H36M test set at its size, as MeTRAbs leaves it:
    S9 and S11 with the 60 activities and frame counts of
    preprocess_metrabs_predictions (2,181 frames), each activity a seeded
    smooth motion seen by phase 6's rig. One dump of monocular 3D
    predictions (the GT plus noise and a per-camera offset) and per-activity
    2D detections (the GT's projections plus 2 px of noise) go through
    preprocess_metrabs_predictions into 3d_metrabs_mono and 2d_metrabs.
    Returns ({subject/activity/poses.npz: GT}, the mean single-camera
    MPJPE in mm)."""
    import contextlib
    import io
    import shutil

    from skelsplat_tpu_torch.data.cameras_io import H36M_CAMERAS
    from skelsplat_tpu_torch.tools import make_synthetic_dataset as synth
    from skelsplat_tpu_torch.tools.h36m import \
        preprocess_metrabs_predictions as metrabs

    cam_dir = root / "3d_gt" / "cameras"
    shutil.copytree(SMOKE_DIR / "synth-h36m" / "initial_guess" / "cameras",
                    cam_dir)
    params = json.loads((cam_dir / "camera-parameters.json").read_text())
    K = {c: np.reshape(params["intrinsics"][c]["calibration_matrix"], (3, 3))
         for c in H36M_CAMERAS}
    rng = np.random.default_rng(1)
    acts = [("S9", a) for a in metrabs.ACTIVITIES_S9] + \
        [("S11", a) for a in metrabs.ACTIVITIES_S11]
    gts, mono, errs = {}, [], []
    for i, ((subject, act), n) in enumerate(zip(
            acts, metrabs.ACTIVITIES_LENGTH, strict=True)):
        gt = synth.make_motion(n, seed=i)
        gts[f"{subject}/{act}/poses.npz"] = gt
        ext = params["extrinsics"][subject]
        det = np.stack([np.stack([
            synth.project(K[c], np.array(ext[c]["R"]),
                          np.reshape(ext[c]["t"], 3), f) for f in gt])
            for c in H36M_CAMERAS])
        d = root / "raw" / subject / act
        d.mkdir(parents=True)
        np.savez(d / "poses2d.npz",
                 poses2d=det + rng.normal(0, 2.0, det.shape))
        for _ in H36M_CAMERAS:
            m = (gt + rng.normal(0, MONO_SIGMA_MM, gt.shape)
                 + rng.normal(0, MONO_SIGMA_MM, 3))
            errs.append(np.linalg.norm(m - gt, axis=-1).mean(axis=-1))
            mono.append(m)
    np.savez(root / "coords3d.npz", coords3d_pred_world=np.concatenate(mono))
    with contextlib.redirect_stdout(io.StringIO()):
        metrabs.main(["--input_dir", str(root / "raw"), "--preds_3d",
                      str(root / "coords3d.npz"), "--output_dir", str(root)])
    return gts, float(np.mean(np.concatenate(errs)))


def _fused_tree(root, name: str, device: str,
                preds_2d: str = "2d_resnet") -> tuple[dict, float, float]:
    """compute_initial_guess on ``device`` into initial_guess/<name>.
    Returns ({file: poses3d}, wall ms of the tool over the tree, ms spent
    in its fuse_poses calls, whose numpy results end each on the host)."""
    import contextlib
    import io

    from skelsplat_tpu_torch.tools.h36m import compute_initial_guess

    fuse, fuse_s = compute_initial_guess.fuse_poses, []

    def timed_fuse(*args, **kwargs):
        t = time.perf_counter()
        out = fuse(*args, **kwargs)
        fuse_s.append(time.perf_counter() - t)
        return out

    compute_initial_guess.fuse_poses = timed_fuse
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            compute_initial_guess.main([
                "--root_dir", str(root), "--preds_2d", preds_2d,
                "--output_name", f"initial_guess/{name}", "--device", device])
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        compute_initial_guess.fuse_poses = fuse
    out = root / "initial_guess" / name
    return {str(p.relative_to(out)): np.load(p)["poses3d"]
            for p in sorted(out.glob("*/*/poses.npz"))}, ms, sum(fuse_s) * 1e3


def _mpjpe(tree: dict, gt: dict) -> float:
    """Mean per-joint error (mm) of ``tree``'s poses against ``gt``'s."""
    return float(np.mean(np.concatenate([
        np.linalg.norm(tree[k] - gt[k], axis=-1).mean(axis=-1)
        for k in tree])))


def _triangulation_guess():
    """Phase 11 (c): phase 8 (e)'s triangulation clouds through
    preprocess_triang_initial_guess. Every frame of the npz tree must be
    bitwise one cloud's xyz, each cloud used once, in sorted order within
    a file. Returns the tree's layout."""
    from skelsplat_tpu_torch.data import ply
    from skelsplat_tpu_torch.tools import preprocess_triang_initial_guess

    clouds = OPTION_DIR / "tri-gpu" / "point_cloud" / "iteration_0"
    xyz = {p.name: ply.read_xyz(str(p)) for p in clouds.glob("*.ply")}
    assert len(xyz) == DATASET_SCENES, sorted(xyz)
    by_bytes = {a.tobytes(): n for n, a in xyz.items()}
    out = TOOLS_DIR / "synth-panoptic"
    preprocess_triang_initial_guess.main([
        "--input_dir", str(clouds), "--output_dir", str(out),
        "--name", "triang_panoptic"])
    seen, layout = [], {}
    tree = out / "initial_guess" / "triang_panoptic"
    for f in sorted(tree.rglob("poses.npz")):
        frames = np.load(f)["poses3d"]
        names = [by_bytes.get(np.ascontiguousarray(fr).tobytes())
                 for fr in frames]
        assert frames.dtype == np.float64 and None not in names, f
        assert names == sorted(names), names
        seen += names
        layout[str(f.parent.relative_to(tree))] = names
    assert sorted(seen) == sorted(xyz), (seen, sorted(xyz))
    print(f"  (c) preprocess_triang_initial_guess over {len(xyz)} Panoptic "
          f"clouds: every frame bitwise its PLY's xyz; layout {layout} "
          f"(the name's first two '_' fields, as in the JAX tool)",
          flush=True)
    return layout


def phase_tools(card: str):
    """Phase 11: the data-preparation path. Returns (K1 launches of (b),
    the phase's numbers)."""
    import shutil

    from skelsplat_tpu_torch import eval as eval_cli
    from skelsplat_tpu_torch.config import load_config

    shutil.rmtree(TOOLS_DIR, ignore_errors=True)

    # (a) the fusion over the H36M test set's 2,181 frames, card against CPU
    full = TOOLS_DIR / "test-set-h36m"
    gt, mono_mpjpe = _test_set_inputs(full)
    # the first call on the card pays the float64 kernels' first use; the
    # second, over the same files, is the steady cost
    fused = {}
    for tag, device in (("card_first", "cuda"), ("card", "cuda"),
                        ("cpu", "cpu")):
        fused[tag] = _fused_tree(full, f"metrabs_{tag}", device,
                                 preds_2d="2d_metrabs")
    card_tree, cpu_tree = fused["card"][0], fused["cpu"][0]
    assert sorted(card_tree) == sorted(cpu_tree) == sorted(gt), (
        len(card_tree), len(cpu_tree), len(gt))
    n_frames = sum(len(v) for v in card_tree.values())
    assert n_frames == 2181, n_frames
    assert all(np.isfinite(v).all() for v in card_tree.values())
    d_fuse = max(float(np.abs(card_tree[k] - cpu_tree[k]).max())
                 for k in card_tree)
    fused_mpjpe = _mpjpe(card_tree, gt)
    ms = {f"fusion_{tag}_{part}": r[i] for tag, r in fused.items()
          for i, part in ((1, "tool_ms"), (2, "fuse_ms"))}
    print(f"  (a) compute_initial_guess over {len(card_tree)} activities, "
          f"{n_frames} frames x {N_VIEWS} cameras: tool wall time (files "
          f"included) card {ms['fusion_card_first_tool_ms']:.3f} ms on its "
          f"first call, {ms['fusion_card_tool_ms']:.3f} ms on the second, "
          f"CPU {ms['fusion_cpu_tool_ms']:.3f} ms; of which in fuse_poses "
          f"card {ms['fusion_card_first_fuse_ms']:.3f} / "
          f"{ms['fusion_card_fuse_ms']:.3f} ms, CPU "
          f"{ms['fusion_cpu_fuse_ms']:.3f} ms; largest |card - CPU| "
          f"{d_fuse:.3g} mm; fused MPJPE {fused_mpjpe:.4f} mm against the "
          f"mean single-camera {mono_mpjpe:.4f} mm, on {card}", flush=True)
    assert d_fuse <= FUSE_ATOL_MM, d_fuse
    assert fused_mpjpe < mono_mpjpe, (fused_mpjpe, mono_mpjpe)

    # the fused guesses (b) starts from, on phase 6's tree
    root = TOOLS_DIR / "synth-h36m"
    shutil.copytree(SMOKE_DIR / "synth-h36m", root)
    small_mono = _fusion_inputs(root)
    small_tree = _fused_tree(root, "metrabs_resnet", "cuda")[0]
    small_fused = _mpjpe(small_tree, {
        k: np.load(root / "3d_gt" / k)["poses"][::64] for k in small_tree})
    assert len(small_tree) == CLI_SCENES, sorted(small_tree)
    assert small_fused < small_mono, (small_fused, small_mono)

    # (b) a sweep from the fused guesses
    run_dir = TOOLS_DIR / "run"
    overrides = [f"dataset.data_root={root}",
                 f"dataset.end_scene_id={TOOLS_SCENES}",
                 "dataset.initial_guess=metrabs_resnet"]
    guess_mpjpe = _initial_mpjpe(_loader(load_config(
        "h36m.yaml", overrides, make_run_dir=False), TOOLS_SCENES))
    results, counts = _train(["--config-name", "h36m.yaml", *overrides,
                              f"hydra.run.dir={run_dir}"])
    assert counts == _step_launches(TOOLS_SCENES * ITERATIONS // 4), counts
    assert len(results) == TOOLS_SCENES, results
    summary = json.loads((run_dir / "train_summary.json").read_text())
    res = eval_cli.main(["--config-name", "h36m.yaml", *overrides,
                         f"eval.output_path={run_dir}"])[ITERATIONS]
    s_scene = summary["mean_seconds_per_scene"]
    print(f"  (b) train.main from the fused guesses: launches {counts}; "
          f"absolute MPJPE {res['absolute']:.4f} mm, relative "
          f"{res['relative']:.4f} mm, against the fused guesses' "
          f"{guess_mpjpe:.4f} mm; {s_scene:.6f} s/scene "
          f"(mean_seconds_per_scene; {TOOLS_SCENES} scenes, {ITERATIONS} "
          f"iterations, {N_VIEWS} views at {W}x{H}) on {card}", flush=True)
    assert np.isfinite(res["absolute"]) and res["absolute"] < guess_mpjpe, (
        res, guess_mpjpe)

    # (c) the triangulation guesses
    layout = _triangulation_guess()
    return counts["raster_loss_grad"], {
        **ms, "fusion_frames": n_frames,
        "fusion_card_vs_cpu_mm": d_fuse, "mono_mpjpe_mm": mono_mpjpe,
        "fused_mpjpe_mm": fused_mpjpe, "guess_mpjpe_mm": guess_mpjpe,
        "sweep_mpjpe_mm": res["absolute"], "s_per_scene": s_scene,
        "triang_layout": layout}


def _frame_profile(trainer, frame):
    """K1's kernel records and the device busy time of one profiled run of
    ``frame`` (padded by tools/timing.py::profiled_round, after a
    profiled warm-up run), taken again, up to TRACE_ATTEMPTS times, while
    the profiler drops kernel records. Returns (K1 tile-kernel records,
    live-list records, busy seconds, profiled wall seconds, sessions)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from skelsplat_tpu_torch.tools.timing import PROFILE_EDGE_S, profiled_round

    k = trainer.n_macro
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        walls = []

        def run():
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            for _ in range(2):
                profiled_round(prof, run, 1)
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation]
        tiles = sum(e.count for e in rows if "raster_loss_live" in e.key)
        lists = sum(e.count for e in rows if "live_tiles" in e.key)
        assert tiles <= k and lists <= k, (tiles, lists)
        if tiles == lists == k:
            busy = sum(e.device_time_total for e in rows) / 1e6
            print(f"  profile (session {attempt}, rounds padded by "
                  f"{PROFILE_EDGE_S * 1e3:.0f} ms): {tiles} K1 tile-kernel "
                  f"and {lists} live-list records", flush=True)
            return tiles, lists, busy, walls[-1], attempt
    raise AssertionError(f"no profile of {TRACE_ATTEMPTS} held every K1 "
                         f"record of a frame")


def phase_graphs(card: str, cli_s_per_scene: float):
    """Phase 12: the captured path against the eager one, in this call.
    Returns the JSON-able findings."""
    import shutil

    from collections import Counter

    from skelsplat_tpu_torch import compat, tracing
    from skelsplat_tpu_torch.core.cameras import stack_cameras
    from skelsplat_tpu_torch.data import cameras_io, ply
    from skelsplat_tpu_torch.data.loader import DataLoader
    from skelsplat_tpu_torch.synthetic import synthetic_inputs

    out = {"card": card}
    # (a) one H36M frame, eager and captured, interleaved
    init, gt, p2d, cams_np = synthetic_inputs(1 + GRAPH_FRAMES, W, H,
                                              n_views=N_VIEWS,
                                              n_joints=N_JOINTS, seed=0)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    trainers = {m: make_trainer(ITERATIONS, "cuda", eager=m == "eager")
                for m in ("eager", "captured")}

    def frame(mode, s):
        params, _ = trainers[mode].optimize_scene(init[s], p2d[s], cams,
                                                  gt[s], lean=True)
        return params.xyz.cpu().numpy()

    xyz = {m: frame(m, 0) for m in trainers}   # warm-up; captures the graph
    assert np.array_equal(xyz["eager"], xyz["captured"]), \
        float(np.abs(xyz["eager"] - xyz["captured"]).max())
    times = {m: [] for m in trainers}
    runs_before = Counter(tracing.counters["k1_run_length"])
    for s in range(1, 1 + GRAPH_FRAMES):
        got = {}
        for m in trainers:
            torch.cuda.synchronize()
            before = _launches()
            t0 = time.perf_counter()
            got[m] = frame(m, s)
            times[m].append(time.perf_counter() - t0)
            launched = _launches(since=before)
            assert launched == _step_launches(ITERATIONS // 4), (m, launched)
        assert np.array_equal(got["eager"], got["captured"]), s
    runs_a = _runs_since(runs_before)
    assert runs_a == {str(k1_run_length(N_VIEWS, W, H, N_JOINTS)):
                      2 * GRAPH_FRAMES * ITERATIONS // 4}, runs_a
    (graph,) = trainers["captured"].graphs.values()
    s_frame = {m: float(np.median(t)) for m, t in times.items()}
    tiles, lists, busy, wall_p, sessions = _frame_profile(
        trainers["captured"], lambda: frame("captured", 1))
    out["a"] = {
        "s_per_frame_eager": s_frame["eager"],
        "s_per_frame_captured": s_frame["captured"],
        "frames_eager": times["eager"], "frames_captured": times["captured"],
        "capture_s": graph.capture_seconds,
        "instantiate_s": graph.instantiate_seconds,
        "graph_nodes": graph.nodes,
        "replay_counts": {"/".join(k): n for k, n in
                          graph.step_program.credit.counts.items()},
        "k1_launches_counter": ITERATIONS // 4,
        "k1_records_profiler": tiles, "live_list_records_profiler": lists,
        "device_busy_s": busy,
        "busy_share_of_frame": busy / s_frame["captured"],
        "busy_share_of_profiled_wall": busy / wall_p,
        "profile_sessions": sessions, "k1_run_length": runs_a}
    print(f"  (a) one H36M frame ({ITERATIONS} iterations, 4 views at "
          f"{W}x{H}), xyz bitwise eager = captured on {1 + GRAPH_FRAMES} "
          f"frames: eager {s_frame['eager']:.6f} s/frame, captured "
          f"{s_frame['captured']:.6f} s/frame (medians of {GRAPH_FRAMES}: "
          f"{[round(t, 6) for t in times['eager']]}, "
          f"{[round(t, 6) for t in times['captured']]}); capture "
          f"{graph.capture_seconds:.4f} s, instantiate "
          f"{graph.instantiate_seconds:.4f} s, {graph.nodes} nodes a graph; "
          f"K1 launches {ITERATIONS // 4} (counter) and {tiles} (profiler); "
          f"device busy {busy:.4f} s = {busy / s_frame['captured']:.4f} of "
          f"a captured frame; K1 calls by run length over the timed eager "
          f"and captured frames {runs_a} on {card}", flush=True)
    assert tiles == ITERATIONS // 4

    # (b) phase 6's tree through the CLI: chained against serial
    root = SMOKE_DIR / "synth-h36m"
    base = [f"dataset.data_root={root}", f"dataset.end_scene_id={CLI_SCENES}",
            "debug.save_images=false",
            "training.early_stopping=opt_early_stopping"]
    runs, runs_b = {}, {}
    for mode, extra in (("chained", [f"training.fetch_scenes={CLI_SCENES}"]),
                        ("serial", ["training.pipeline_scenes=false"])):
        run_dir = GRAPH_DIR / mode
        shutil.rmtree(run_dir, ignore_errors=True)
        runs_before = Counter(tracing.counters["k1_run_length"])
        results, counts = _train(["--config-name", "h36m.yaml", *base,
                                  *extra, f"hydra.run.dir={run_dir}"])
        assert counts == _step_launches(CLI_SCENES * ITERATIONS // 4, 0), \
            (mode, counts)
        runs_b[mode] = _runs_since(runs_before)
        assert runs_b[mode] == {str(k1_run_length(N_VIEWS, W, H, N_JOINTS)):
                                counts["raster_loss_grad"]}, runs_b
        runs[mode] = (run_dir, json.loads(
            (run_dir / "train_summary.json").read_text()))
    (cdir, chained), (sdir, serial) = runs["chained"], runs["serial"]
    assert chained["pipelined_scenes"] and not serial["pipelined_scenes"]
    assert len(chained["scenes"]) == len(serial["scenes"]) == CLI_SCENES
    for c, r in zip(chained["scenes"], serial["scenes"]):
        for key in ("scene_name", "abs_error", "rel_error", "stopped_at"):
            assert c[key] == r[key], (key, c, r)
        rel = (Path("point_cloud") / f"iteration_{c['stopped_at'] or ITERATIONS}"
               / f"{c['scene_name']}.ply")
        assert (cdir / rel).read_bytes() == (sdir / rel).read_bytes(), rel
    out["b"] = {"s_per_scene_chained": chained["mean_seconds_per_scene"],
                "s_per_scene_serial": serial["mean_seconds_per_scene"],
                "stopped_at": [c["stopped_at"] for c in chained["scenes"]],
                "k1_run_length": runs_b}
    print(f"  (b) phase 6's tree, opt_early_stopping: chained "
          f"(fetch_scenes={CLI_SCENES}) {out['b']['s_per_scene_chained']:.6f} "
          f"s/scene, pipeline_scenes=false "
          f"{out['b']['s_per_scene_serial']:.6f} s/scene (phase 6, "
          f"save_images, {cli_s_per_scene:.6f}); summary rows and PLYs "
          f"bitwise; stops {out['b']['stopped_at']}; K1 calls by run length "
          f"{runs_b} on {card}", flush=True)

    # (c) phase 7's batched sweep, captured against eager
    broot = BATCH_DIR / "synth-h36m"
    loader = DataLoader(str(broot), str(broot / "initial_guess" / "metrabs"),
                        str(broot / "2d_metrabs"), end_id=BATCH_SCENES)
    recs = [rec for _, rec in loader]
    groups = [recs[i:i + SCENE_BATCH]
              for i in range(0, len(recs), SCENE_BATCH)]
    inputs = []
    for g in groups:
        cams_g = [cameras_io.build_camera_batch(r.cameras, device="cpu")
                  for r in g]
        inputs.append((np.stack([r.pose_3d for r in g]),
                       np.stack([np.asarray(r.poses_2d)[..., :2] for r in g]),
                       stack_cameras(cams_g),
                       np.stack([r.pose_3d_gt for r in g])))
    assert all(int(x[2].width.max()) == W for x in inputs)
    batch_trainers = {m: make_trainer(ITERATIONS, "cuda", eager=m == "eager")
                      for m in ("eager", "captured")}

    def sweep(mode):
        xs = []
        for x in inputs:
            params, _ = batch_trainers[mode].optimize_scene_batch(*x,
                                                                  lean=True)
            xs.append(params.xyz.cpu().numpy())
        return np.concatenate(xs)

    sweep_s = {m: [] for m in batch_trainers}
    xyz_b = {}
    runs_before = Counter(tracing.counters["k1_run_length"])
    for rep in range(2):     # the first pass warms up and captures
        for m in batch_trainers:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xyz_b[m] = sweep(m)
            sweep_s[m].append(time.perf_counter() - t0)
        assert np.array_equal(xyz_b["eager"], xyz_b["captured"]), rep
    runs_c = _runs_since(runs_before)
    want = Counter()
    for g in groups:     # 125 calls a group, in each of 2 passes of 2 modes
        want[str(k1_run_length(N_VIEWS * len(g), W, H, N_JOINTS))] += \
            4 * ITERATIONS // 4
    assert runs_c == dict(want), (runs_c, want)
    cli_pc = BATCH_DIR / f"run_b{SCENE_BATCH}" / "point_cloud" / \
        f"iteration_{ITERATIONS}"
    for r, x in zip(recs, xyz_b["captured"]):
        assert np.array_equal(ply.read_xyz(str(cli_pc / f"{r.scene_name}.ply")),
                              x), r.scene_name
    n = len(recs)
    out["c"] = {"s_per_scene_eager": sweep_s["eager"][-1] / n,
                "s_per_scene_captured": sweep_s["captured"][-1] / n,
                "warm_up_pass_s": {m: v[0] for m, v in sweep_s.items()},
                "graphs": len(batch_trainers["captured"].graphs),
                "k1_run_length": runs_c}
    print(f"  (c) phase 7's {n} scenes in batches of {SCENE_BATCH} "
          f"({[len(g) for g in groups]}): eager "
          f"{out['c']['s_per_scene_eager']:.6f} s/scene, captured "
          f"{out['c']['s_per_scene_captured']:.6f} s/scene (second pass; "
          f"the first {sweep_s['eager'][0]:.3f} and "
          f"{sweep_s['captured'][0]:.3f} s); bitwise, and the captured xyz "
          f"bitwise phase 7's PLYs; K1 calls by run length {runs_c}, on "
          f"{card}", flush=True)
    return out


def _runs_since(before) -> dict:
    """K1's calls by run length (the tracing counter ``k1_run_length``)
    since the counts ``before``."""
    from skelsplat_tpu_torch import tracing

    return dict(tracing.counters["k1_run_length"] - before)


def _macro_step_without_sync(trainer, inputs):
    """One eager macro step of ``trainer`` over device ``inputs`` (a
    ``host_inputs`` tuple after ``put_trees``) under the sync detector's
    "error" mode, after one step that sets up autograd: a host sync
    raises."""
    init, p2d, cams, gt, drop, extent = inputs
    params, aux = trainer._prepare(init, p2d, cams, drop)
    nviews = p2d.shape[0]
    state = trainer._loop_state(params, nviews, None, False)
    step = trainer._step_fn(trainer._visited_grads(cams, aux, p2d, 1, nviews),
                            nviews, gt, extent, False)
    step(state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _captured_and_eager(make, inputs, runs=("captured", "eager",
                                            "captured")):
    """Scenes of ``inputs`` (device ``host_inputs``) through an eager and
    a capturing trainer from ``make(eager)``, in the order ``runs``, each
    timed through a host copy of xyz, with its peak device memory, its K1
    launches and its step replays. Returns (trainers, per-run records)."""
    from skelsplat_tpu_torch import tracing

    trainers = {m: make(m == "eager") for m in set(runs)}
    assert trainers["captured"].captures and not trainers["eager"].captures
    records = []
    for m in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _launches()
        steps = tracing.counters["graph_launches"]["step"]
        t0 = time.perf_counter()
        params, _ = trainers[m].optimize_scene(None, None, inputs=inputs,
                                               lean=True)
        xyz = params.xyz.cpu().numpy()
        records.append({
            "mode": m, "s": time.perf_counter() - t0, "xyz": xyz,
            "step_replays": tracing.counters["graph_launches"]["step"] - steps,
            "peak_allocated": torch.cuda.max_memory_allocated(),
            "peak_reserved": torch.cuda.max_memory_reserved(),
            "launches": _launches(since=before)})
        assert records[-1]["launches"] == _step_launches(
            0, ITERATIONS // 4), records[-1]
        assert np.isfinite(xyz).all()
    for r in records[1:]:
        assert np.array_equal(r["xyz"], records[0]["xyz"]), \
            (r["mode"], float(np.abs(r["xyz"] - records[0]["xyz"]).max()))
    return trainers, records


def _summary(trainers, records):
    """s and peak memory of each run, and the graph's nodes and capture
    time."""
    (graph,) = trainers["captured"].graphs.values()
    return {"runs": [{k: v for k, v in r.items() if k != "xyz"}
                     for r in records],
            "graph_nodes": graph.nodes,
            "capture_s": graph.capture_seconds,
            "instantiate_s": graph.instantiate_seconds}


def _time_graft_entry(card: str):
    """Phase 13 (c): graft_entry.entry() on the card against the CPU, then
    captured and replayed."""
    from skelsplat_tpu_torch import graft_entry

    fwd, args = graft_entry.entry()
    fwd_cpu, args_cpu = graft_entry.entry(device="cpu")
    with torch.no_grad():
        loss = fwd(*args)
        loss_cpu = float(fwd_cpu(*args_cpu))
        torch.cuda.synchronize()
        rel = abs(float(loss) / loss_cpu - 1)
        assert rel <= GRAFT_RTOL, (float(loss), loss_cpu)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fwd(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = fwd(*args)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, loss), (float(static), float(loss))
        ms = {}
        for name, run in (("eager", lambda: fwd(*args)),
                          ("replay", graph.replay)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            run()
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                run()
            end.record()
            torch.cuda.synchronize()
            ms[name] = start.elapsed_time(end) / 20
        assert torch.equal(static, loss)
    out = {"loss_card": float(loss), "loss_cpu": loss_cpu, "rel_diff": rel,
           "ms_eager": ms["eager"], "ms_replay": ms["replay"]}
    print(f"  (c) graft_entry.entry(): loss {float(loss)!r} on the card, "
          f"{loss_cpu!r} on the CPU (rel diff {rel:.3g}); captured and "
          f"replayed bitwise the eager value; {ms['eager']:.3f} ms eager, "
          f"{ms['replay']:.3f} ms a replay (CUDA events, 20 calls) on "
          f"{card}", flush=True)
    return out


def phase_renderers(card: str, dense_mpjpe_cli: float):
    """Phase 13: the fused and dense renderers' scenes, captured against
    eager, and the graft entry. Returns the JSON-able findings."""
    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch.config import load_config
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.data import cameras_io
    from skelsplat_tpu_torch.engine import driver
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer
    from skelsplat_tpu_torch.synthetic import mpjpe, synthetic_inputs
    from skelsplat_tpu_torch.utils import put_trees

    out = {"card": card}
    # (a) phase 8 (c)'s dense soft-argmax scene
    root = SMOKE_DIR / "synth-h36m"
    cfg = load_config("h36m.yaml", [
        f"dataset.data_root={root}",
        f"training.loss_function={SOFTARGMAX_LOSS}"], make_run_dir=False)
    _, rec = next(iter(_loader(cfg, 1)))
    m = cfg.model
    model = SkeletonModel("h36m", N_JOINTS, scaling=float(m.scaling),
                          scaling_modifier=float(m.scaling_modifier),
                          opacity_on=bool(m.opacity_on))
    cams = cameras_io.build_camera_batch(rec.cameras, device="cpu")
    W_, H_ = int(cams.width.max()), int(cams.height.max())

    def make_dense(eager):
        t = SceneTrainer(model, driver.opt_config_from(cfg.optimization),
                         driver.train_settings_from(cfg.training), W_, H_,
                         device="cuda", eager=eager)
        assert t.renderer == "dense", t.renderer
        return t

    probe = make_dense(True)
    inputs = put_trees([probe.host_inputs(rec.pose_3d, rec.poses_2d, cams,
                                          rec.pose_3d_gt)], "cuda")[0]
    _macro_step_without_sync(probe, inputs)
    del probe
    trainers, records = _captured_and_eager(make_dense, inputs)
    err = mpjpe(records[-1]["xyz"], rec.pose_3d_gt)
    out["a"] = _summary(trainers, records)
    out["a"].update({"mpjpe_mm": err, "mpjpe_phase8_cli_mm": dense_mpjpe_cli,
                     "mpjpe_pr6_mm": DENSE_MPJPE_PR6})
    del trainers
    (c1, e, c2) = records
    print(f"  (a) dense {SOFTARGMAX_LOSS}, one scene ({ITERATIONS} "
          f"iterations, {N_VIEWS} views at {W_}x{H_}): one eager macro step "
          f"under sync debug mode \"error\" made no sync; captured "
          f"{c1['s']:.6f} s/scene with warm-up and capture, eager "
          f"{e['s']:.6f}, captured {c2['s']:.6f}; xyz bitwise; graph "
          f"{out['a']['graph_nodes']} nodes, capture "
          f"{out['a']['capture_s']:.4f} s, instantiate "
          f"{out['a']['instantiate_s']:.4f} s; peak allocated "
          f"{c1['peak_allocated']} / {e['peak_allocated']} / "
          f"{c2['peak_allocated']} bytes, peak reserved "
          f"{c1['peak_reserved']} / {e['peak_reserved']} / "
          f"{c2['peak_reserved']} bytes (captured / eager / captured); 0 K1 "
          f"launches; MPJPE {err:.4f} mm (phase 8 (c) through the CLI "
          f"{dense_mpjpe_cli:.4f}, PR 6 {DENSE_MPJPE_PR6}) on {card}",
          flush=True)
    torch.cuda.empty_cache()

    # (b) phase 3's H36M frame with the fused renderer
    init, gt, p2d, cams_np = synthetic_inputs(1, W, H, n_views=N_VIEWS,
                                              n_joints=N_JOINTS, seed=0)
    fcams = compat.camera_from_numpy(cams_np, device="cpu")

    def make_fused(eager):
        return make_trainer(ITERATIONS, "fused", eager=eager)

    probe = make_fused(True)
    inputs = put_trees([probe.host_inputs(init[0], p2d[0], fcams, gt[0])],
                       "cuda")[0]
    _macro_step_without_sync(probe, inputs)
    del probe
    trainers, records = _captured_and_eager(make_fused, inputs)
    out["b"] = _summary(trainers, records)
    out["b"]["mpjpe_mm"] = mpjpe(records[-1]["xyz"], gt[0])
    del trainers
    (c1, e, c2) = records
    print(f"  (b) fused, phase 3's H36M frame: one eager macro step under "
          f"\"error\" made no sync; captured {c1['s']:.6f} s/frame with "
          f"warm-up and capture, eager {e['s']:.6f}, captured "
          f"{c2['s']:.6f}; xyz bitwise; graph {out['b']['graph_nodes']} "
          f"nodes, capture {out['b']['capture_s']:.4f} s; peak allocated "
          f"{c1['peak_allocated']} / {e['peak_allocated']} / "
          f"{c2['peak_allocated']} bytes; MPJPE {out['b']['mpjpe_mm']:.4f} "
          f"mm from {mpjpe(init[0], gt[0]):.4f} on {card}", flush=True)
    assert out["b"]["mpjpe_mm"] < mpjpe(init[0], gt[0])
    torch.cuda.empty_cache()

    out["c"] = _time_graft_entry(card)
    return out


class _Split:
    """Host seconds and calls of the functions a sweep runs, by name,
    through wrappers patched onto their modules for one run."""

    def __init__(self):
        self.times, self._undo = {}, []

    def wrap(self, owner, attr: str, name: str):
        orig = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))

    def seconds(self, name: str) -> float:
        return float(sum(self.times.get(name, ())))

    def restore(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def _chained_split(card: str, tensorboard: bool):
    """Phase 14 (d): phase 7's 10-scene tree through train.main, chained
    (fetch_scenes=4: groups of 4, 4 and 2, one pending), with or without
    the TensorBoard log (without it, each scene's telemetry is its last
    row), its wall time split by host timers around the sweep's functions
    and CUDA events around each group's dispatch. Returns (K1 launches,
    the split, the PLYs' bytes)."""
    import shutil

    from skelsplat_tpu_torch import eval as eval_cli
    from skelsplat_tpu_torch.data import cameras_io, loader, ply
    from skelsplat_tpu_torch.engine import driver
    from skelsplat_tpu_torch.engine import trainer as trainer_mod

    root = BATCH_DIR / "synth-h36m"
    run_dir = PREPARE_DIR / ("chained_tb" if tensorboard else "chained")
    shutil.rmtree(run_dir, ignore_errors=True)
    split = _Split()
    groups = []     # (start event, end event, device busy at return)

    def chain(orig):
        def run(self, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(self, *args, **kwargs)
            end.record()
            groups.append((start, end, not end.query()))
            return out
        return run

    split.wrap(loader.DataLoader, "__init__", "loader")
    split.wrap(cameras_io, "build_camera_batch", "cameras")
    split.wrap(driver, "_save_scene_artifacts", "artifacts")
    split.wrap(trainer_mod.SceneTrainer, "host_inputs", "host_inputs")
    split.wrap(trainer_mod, "put_trees", "packed_copy")
    orig_chain = trainer_mod.SceneTrainer.optimize_scene_chain
    trainer_mod.SceneTrainer.optimize_scene_chain = chain(orig_chain)
    split.wrap(trainer_mod.SceneTrainer, "optimize_scene_chain", "dispatch")
    split.wrap(driver._Fetch, "__init__", "fetch_start")
    split.wrap(driver._Fetch, "result", "fetch_wait")
    split.wrap(ply, "write_gaussian_ply", "ply_writes")
    split.wrap(driver, "_log_tb_history", "tensorboard")
    split.wrap(trainer_mod.SceneTrainer, "__init__", "trainer_setup")
    overrides = [f"dataset.data_root={root}",
                 f"dataset.end_scene_id={BATCH_SCENES}"]
    try:
        t0 = time.perf_counter()
        results, counts = _train([
            "--config-name", "h36m.yaml", *overrides,
            "debug.save_images=false", f"training.fetch_scenes={CHAIN_GROUP}",
            f"+debug.tensorboard={str(tensorboard).lower()}",
            f"hydra.run.dir={run_dir}"])
        main_s = time.perf_counter() - t0
    finally:
        split.restore()
        trainer_mod.SceneTrainer.optimize_scene_chain = orig_chain
    t0 = time.perf_counter()
    res = eval_cli.main(["--config-name", "h36m.yaml", *overrides,
                         f"eval.output_path={run_dir}"])[ITERATIONS]
    eval_s = time.perf_counter() - t0
    n = len(results)
    assert n == BATCH_SCENES, n
    assert counts == _step_launches(n * ITERATIONS // 4), counts
    assert len(split.times["dispatch"]) == len(groups) == 3, split.times
    summary = json.loads((run_dir / "train_summary.json").read_text())
    device_s = [a.elapsed_time(b) / 1e3 for a, b, _ in groups]
    sec = split.seconds
    # the chain's own call holds its packed copy: dispatch is the rest; the
    # first group's also warms up and captures the shape's programs
    dispatch = [d - c for d, c in zip(split.times["dispatch"],
                                      split.times["packed_copy"])]
    in_sweep = {
        "trainer set-up": sec("trainer_setup"),
        "cameras + artifacts": sec("cameras") + sec("artifacts"),
        "host_inputs": sec("host_inputs"),
        "packed copy": sec("packed_copy"),
        "dispatch, group 1 (warm-up steps, captures)": dispatch[0],
        "dispatch, later groups (graph launches)": sum(dispatch[1:]),
        "fetch start": sec("fetch_start"),
        "wait for the result fetch": sec("fetch_wait"),
        "PLY writes": sec("ply_writes"),
        "TensorBoard scalars": sec("tensorboard")}
    wall = summary["sweep_wall_seconds"]
    parts = {"loader (DataLoader, before the sweep)": sec("loader"),
             **in_sweep,
             "the rest of the sweep": wall - sum(in_sweep.values())}
    out = {"scenes": n, "groups": len(groups),
           "train_main_s": main_s, "sweep_wall_s": wall,
           "s_per_scene": summary["mean_seconds_per_scene"],
           "split_s_per_scene": {k: v / n for k, v in parts.items()},
           "dispatch_s_by_group": dispatch,
           "eval_s_per_scene": eval_s / n,
           "group_device_s": device_s,
           "group_busy_at_return": [b for _, _, b in groups],
           "device_s_per_scene": sum(device_s) / n,
           "device_share_of_sweep": sum(device_s) / wall,
           "mpjpe_mm": res["absolute"]}
    print(f"  (d) phase 7's {n} scenes chained (fetch_scenes={CHAIN_GROUP}: "
          f"{len(groups)} groups), TensorBoard {'on' if tensorboard else 'off'}"
          f", through train.main: "
          f"{out['s_per_scene']:.6f} s/scene of sweep wall "
          f"({wall:.4f} s; train.main {main_s:.4f} s); per scene: "
          + ", ".join(f"{k} {v / n * 1e3:.3f} ms" for k, v in parts.items())
          + f"; eval.main {eval_s / n * 1e3:.3f} ms; dispatch by group "
          f"{[round(d, 6) for d in dispatch]} s; device "
          f"{out['device_s_per_scene']:.6f} s/scene by CUDA events around "
          f"each group ({[round(d, 6) for d in device_s]} s), "
          f"{out['device_share_of_sweep']:.4f} of the sweep wall; each "
          f"group's dispatch returned with its device work still running: "
          f"{out['group_busy_at_return']}; MPJPE {res['absolute']:.4f} mm "
          f"on {card}", flush=True)
    assert all(out["group_busy_at_return"]), out
    plys = {p.name: p.read_bytes()
            for p in sorted((run_dir / "point_cloud").rglob("*.ply"))}
    assert len(plys) == n, sorted(plys)
    return counts, out, plys


def _median_call(fn, reps: int):
    """(host seconds through a synchronize, device seconds by CUDA events)
    of ``fn``, medians of ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        dev.append(start.elapsed_time(end) / 1e3)
    return float(np.median(host)), float(np.median(dev))


def _same_tree(a, b) -> float:
    """0.0 when two trees of tensors are bitwise equal, else the largest
    absolute difference of a leaf that is not."""
    from skelsplat_tpu_torch.utils import tree_leaves

    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.shape == y.shape, (x.shape, y.shape)
        if not torch.equal(x, y):
            worst = max(worst, float((x.double() - y.double()).abs().max()),
                        1e-300)
    return worst


def phase_prepare(card: str):
    """Phase 14: each scene's prepare inside its captured program. Returns
    (K1 launches of (a)'s checked chain and batch, of (d)'s sweep, the
    JSON-able findings)."""
    from skelsplat_tpu_torch import compat
    from skelsplat_tpu_torch.core.cameras import stack_cameras
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings
    from skelsplat_tpu_torch.synthetic import synthetic_inputs

    out = {"card": card}
    # (a) no host wait: a warm chain of 4 H36M scenes, a warm batch of 8;
    # first, phase 3's captured frame in this process, to hold (d) against
    init, gt, p2d, cams_np = synthetic_inputs(
        SCENE_BATCH, W, H, n_views=N_VIEWS, n_joints=N_JOINTS, seed=0,
        widths=MIXED_WIDTHS)
    cams = compat.camera_from_numpy(cams_np, device="cpu")
    cams_b = stack_cameras([cams] * SCENE_BATCH)
    frame_tr = make_trainer(ITERATIONS, "cuda")
    frames = []
    for s in range(1 + TIMED_FRAMES):     # the first warms up and captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, _ = frame_tr.optimize_scene(init[s], p2d[s], cams, gt[s],
                                            lean=True)
        params.xyz.cpu()
        frames.append(time.perf_counter() - t0)
    s_frame = float(np.median(frames[1:]))
    del frame_tr
    tr = SceneTrainer(SkeletonModel("h36m", N_JOINTS, scaling=3.0),
                      OptConfig(iterations=ITERATIONS),
                      TrainSettings(early_stopping="opt_early_stopping"),
                      W, H, renderer="cuda", device="cuda")
    hins = [tr.host_inputs(init[s], p2d[s], cams, gt[s])
            for s in range(CHAIN_GROUP)]
    for _ in range(2):      # warm-up steps, then the captures
        tr.optimize_scene_chain(hins)
        tr.optimize_scene_batch(init, p2d, cams_b, gt)
    torch.cuda.synchronize()
    before = _launches()
    times = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, run in (("chain", lambda: tr.optimize_scene_chain(hins)),
                          ("batch", lambda: tr.optimize_scene_batch(
                              init, p2d, cams_b, gt))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            params, _ = run()
            host = time.perf_counter() - t0
            end.record()
            times[name] = (host, start, end, not end.query(), params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = _launches(since=before)
    assert launches == _step_launches((CHAIN_GROUP + 1) * ITERATIONS // 4,
                                      0), launches
    out["a"] = {"s_per_frame_captured": s_frame, "frames_s": frames[1:]}
    for name, (host, start, end, busy, params) in times.items():
        assert torch.isfinite(params.xyz).all(), name
        out["a"][name] = {"host_s": host,
                          "device_s": start.elapsed_time(end) / 1e3,
                          "busy_at_return": busy}
        assert busy, (name, out["a"])
    a = out["a"]
    print(f"  (a) phase 3's captured frame in this process: {s_frame:.6f} "
          f"s/frame (median of {TIMED_FRAMES}: "
          f"{[round(t, 6) for t in frames[1:]]}) on {card}", flush=True)
    print(f"  (a) under torch.cuda.set_sync_debug_mode(\"error\"), no sync: "
          f"a warm optimize_scene_chain of {CHAIN_GROUP} H36M scenes "
          f"(opt_early_stopping) returned after {a['chain']['host_s']:.6f} s "
          f"of host time against {a['chain']['device_s']:.6f} s of device "
          f"time, a warm optimize_scene_batch of {SCENE_BATCH} after "
          f"{a['batch']['host_s']:.6f} s against "
          f"{a['batch']['device_s']:.6f} s; each returned with its work "
          f"still running; K1 launches {launches['raster_loss_grad']} on "
          f"{card}", flush=True)

    # (c) the prepare programs of the two shapes (printed with (b))
    out["c"] = {}
    for key, graph in tr.graphs.items():
        label = "one scene" if not key[0] else f"batch of {key[0][0]}"
        prog = graph.prepare_program
        reps = 20
        graph.scene.zero_()     # a chain's collect left it past the group
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        graph.prepare()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.prepare()
        end.record()
        torch.cuda.synchronize()
        out["c"][label] = {
            "prepare_nodes": prog.nodes,
            "prepare_capture_s": prog.capture_seconds,
            "prepare_instantiate_s": prog.instantiate_seconds,
            "prepare_replay_ms": start.elapsed_time(end) / reps,
            "collect_nodes": graph.collect_program.nodes,
            "step_nodes": graph.nodes}

    # (b) the vectorized prepare against B one-scene prepares
    eager = make_trainer(ITERATIONS, "cuda", eager=True)
    out["b"] = {}
    for nviews, sizes in ((N_VIEWS, PREPARE_BATCHES), (3, (SCENE_BATCH,))):
        for B in sizes:
            init, _, p2d, cams_np = synthetic_inputs(
                B, W, H, n_views=nviews, n_joints=N_JOINTS, seed=1,
                widths=MIXED_WIDTHS[:nviews])
            cams = compat.camera_from_numpy(cams_np, device="cuda")
            cams_b = stack_cameras([cams] * B)
            init_d = torch.as_tensor(init, device="cuda")
            p2d_d = torch.as_tensor(p2d, device="cuda")
            drop = torch.zeros((B, nviews, N_JOINTS), dtype=torch.bool,
                               device="cuda")

            def vectorized():
                return eager._prepare_batch(init_d, p2d_d, cams_b, drop)

            def loop():
                return [eager._prepare(init_d[b], p2d_d[b], cams, drop[b])
                        for b in range(B)]

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            params_b, aux_b = vectorized()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            worst = 0.0
            for b, (params, aux) in enumerate(loop()):
                worst = max(worst, _same_tree(
                    (params_b.map(lambda x, b=b: x[b]),
                     aux_b.take(slice(b * nviews, (b + 1) * nviews))),
                    (params, aux)))
            del params_b, aux_b
            reps = 3 if B <= 128 else 2
            v_host, v_dev = _median_call(vectorized, reps)
            l_host, l_dev = _median_call(loop, reps)
            rec = {"views": nviews, "scenes": B, "bitwise": worst == 0.0,
                   "max_abs_diff": worst, "vectorized_s": v_host,
                   "vectorized_device_s": v_dev, "loop_s": l_host,
                   "loop_device_s": l_dev, "peak_bytes": peak}
            out["b"][f"v{nviews}_b{B}"] = rec
            print(f"  (b) {B} scenes x {nviews} views at {W}x{H}: the "
                  f"vectorized prepare {v_host * 1e3:.3f} ms (device "
                  f"{v_dev * 1e3:.3f} ms by CUDA events), {B} one-scene "
                  f"prepares {l_host * 1e3:.3f} ms (device "
                  f"{l_dev * 1e3:.3f}): {l_host / v_host:.1f}x; peak "
                  f"{peak} bytes; bitwise the loop: {worst == 0.0} (largest "
                  f"difference {worst:.3g}) on {card}", flush=True)
            assert worst == 0.0, rec
            torch.cuda.empty_cache()
    for label, rec in out["c"].items():
        print(f"  (c) the prepare program of {label}: {rec['prepare_nodes']} "
              f"nodes, capture {rec['prepare_capture_s']:.4f} s, "
              f"instantiate {rec['prepare_instantiate_s']:.4f} s, a replay "
              f"{rec['prepare_replay_ms']:.4f} ms (CUDA events, 20); the "
              f"collect {rec['collect_nodes']} nodes, the step "
              f"{rec['step_nodes']} on {card}", flush=True)
    del tr, eager
    torch.cuda.empty_cache()

    # (d) the split of a chained CLI sweep's wall time, with and without
    # the TensorBoard log: the same clouds either way
    out["d"], plys = {}, {}
    for tb in (True, False):
        label = "tensorboard" if tb else "no_tensorboard"
        split_counts, out["d"][label], plys[tb] = _chained_split(card, tb)
    assert plys[True] == plys[False]
    for label, rec in out["d"].items():
        print(f"  (d) chained sweep, {label}: {rec['s_per_scene']:.6f} "
              f"s/scene against (a)'s captured frame {s_frame:.6f} s/frame: "
              f"{rec['s_per_scene'] / s_frame:.4f}x on {card}", flush=True)
    return launches["raster_loss_grad"], split_counts["raster_loss_grad"], out


def _step_launches(steps: int, adam: int | None = None) -> dict:
    """The launch counters after ``steps`` macro steps of the kernel
    renderer: one launch of kernel A, K1 and kernel B a step, and ``adam``
    of kernel C (default ``steps``): one a macro step of any renderer
    whose settings the routing sends to it (no early stopping, A = V, the
    mean fusion), 0 where they keep the torch composite."""
    return {"raster_loss_grad": steps, "raster_loss": 0,
            "preprocess_pack": steps, "preprocess_grad": steps,
            "compose_adam": steps if adam is None else adam, "issue_rate": 0}


def _launches(since: dict | None = None) -> dict:
    """Each kernel's launches by label, zeros included: in this process,
    or since the counts ``since`` (``_build.launch_counts``)."""
    from skelsplat_tpu_torch.ops import _build

    return _build.launch_counts(since)


def _bench_launches(args) -> int:
    """K1 launches of one bench invocation of parsed options ``args``: 125
    a scene over the latency frames (frames + 1), the warm chains (one of
    each group size the sweep uses) and the swept frames, 125 a batch call
    (a warm one and two timed) with ``--batch`` > 1, and 125 a profiled
    frame (a warm-up round and the recorded one) with ``--profile``."""
    frames, group = args.frames, args.group
    sizes = {min(group, frames)} | ({frames % group} - {0})
    scenes = frames + 1 + sum(sizes) + frames
    scenes += 3 if args.batch > 1 else 0
    scenes += 2 if args.profile else 0
    return ITERATIONS // 4 * scenes


def _bench(argv, card: str):
    """``bench.main(argv)`` as a user runs it, its stdout captured, with K1
    launches counted around it alone. Checks its last line (the root
    bench's four keys, a finite positive value) and its K1 launches.
    Returns (results, K1 launches, wall seconds)."""
    import contextlib
    import gc
    import io
    import math

    from skelsplat_tpu_torch import bench

    args = bench.parser().parse_args(argv)
    gc.collect()        # the previous invocation's graphs
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = _launches()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = bench.main(argv)
    wall = time.perf_counter() - t0
    launches = _launches(since=before)
    record = json.loads(printed.getvalue().splitlines()[-1])
    assert list(record) == ["metric", "value", "unit", "vs_baseline"], record
    assert record["metric"] == f"{args.preset}_frame_opt_seconds", record
    assert math.isfinite(record["value"]) and record["value"] > 0, record
    assert record["value"] == round(res["value"], 4), (record, res["value"])
    assert np.isfinite(res["sweep_xyz"]).all()
    assert res["sweep_xyz"].shape == (args.frames, bench.PRESETS[
        args.preset][2], 3)
    want = _bench_launches(args)
    assert launches == _step_launches(want), (argv, launches, want)
    batch = "" if res["batch"] is None else \
        f", batch of {args.batch} {res['batch']:.6f}"
    print(f"  bench {' '.join(argv) or '(defaults)'}: latency "
          f"{res['latency']:.6f} s/frame (median of {args.frames}), sweep "
          f"{res['sweep']:.6f}{batch} s/frame; line {json.dumps(record)}; "
          f"{launches['raster_loss_grad']} K1 launches; {wall:.1f} s on "
          f"{card}", flush=True)
    return res, launches["raster_loss_grad"], wall


def phase_bench(card: str):
    """Phase 15: the benchmark entry point. Returns its K1 launches (the
    default run's, and each shorter run's by its options) and the
    JSON-able findings."""
    import shutil

    from skelsplat_tpu_torch import bench
    from skelsplat_tpu_torch.tools import trace_summary

    t0 = time.perf_counter()
    out = {"card": card}
    launches = {}

    def record(label, res, wall):
        out[label] = {"latency": res["latency"], "sweep": res["sweep"],
                      "batch": res["batch"], "value": res["value"],
                      "wall_s": wall}

    # (a) the default invocation
    res, launches["default"], wall = _bench([], card)
    record("default", res, wall)
    # (b) the other presets, shorter; h36m-occ against its serial loop
    for preset in BENCH_PRESETS:
        res, launches[preset], wall = _bench(["--preset", preset]
                                             + list(BENCH_SHORT), card)
        record(preset, res, wall)
        if preset != "h36m-occ":
            continue
        W, H, nj = bench.PRESETS[preset][:3]
        n = res["sweep_xyz"].shape[0] + 1
        tr = bench.make_trainer(preset, W, H, ITERATIONS, "cuda")
        init, gt, p2d, cams = bench._synthetic_inputs(n, W, H, n_joints=nj,
                                                      device="cpu")
        masks = bench.dropout_masks(n, N_VIEWS, nj)
        assert any(m.any() for m in masks[1:])
        serial = np.stack([tr.optimize_scene(
            init[s], p2d[s], cams, gt[s], lean=True,
            drop_mask=masks[s])[0].xyz.cpu().numpy() for s in range(1, n)])
        diff = float(np.abs(res["sweep_xyz"] - serial).max())
        out[preset]["serial_max_abs_diff"] = diff
        print(f"  (b) {preset}'s swept xyz against a serial optimize_scene "
              f"loop over the same {n - 1} scenes and dropout masks: "
              f"largest |dxyz| {diff:.3g} mm (bitwise: {diff == 0.0})",
              flush=True)
        assert np.array_equal(res["sweep_xyz"], serial), diff
        del tr
    # (c) the batch
    res, launches["batch"], wall = _bench(
        ["--batch", str(BENCH_BATCH)] + list(BENCH_SHORT), card)
    record("batch", res, wall)
    assert res["value"] == res["batch"]
    assert res["batch_xyz"].shape == (2, BENCH_BATCH, N_JOINTS, 3)
    assert np.isfinite(res["batch_xyz"]).all()
    # (d) the profile, last: a profiler session leaves its hooks on
    k = ITERATIONS // 4
    for attempt in range(1, BENCH_PROFILE_ATTEMPTS + 1):
        prof_dir = BENCH_DIR / f"profile_{attempt}"
        shutil.rmtree(prof_dir, ignore_errors=True)
        res, _, wall = _bench(["--frames", "1", "--group", "1", "--profile",
                               str(prof_dir)], card)
        events = trace_summary.load_trace_events(res["trace"])
        _, counts, _, _ = trace_summary.summarize(
            events, top=4, macros=k, out=lambda r: print(f"    {r}"))
        tiles = sum(c for name, c in counts.items()
                    if "raster_loss_live" in name)
        lists = sum(c for name, c in counts.items() if "live_tiles" in name)
        print(f"  (d) profile {attempt}: {tiles} K1 tile-kernel and {lists} "
              f"live-list records in {res['trace']}", flush=True)
        assert tiles <= k and lists <= k, (tiles, lists)
        if tiles == lists == k:
            out["profile"] = {"attempts": attempt, "k1_records": tiles}
            break
    else:
        raise AssertionError(f"no bench profile of {BENCH_PROFILE_ATTEMPTS} "
                             f"held every K1 record of its frame")
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 15 ran {out['wall_s']:.1f} s in its process on {card}",
          flush=True)
    return launches, out


def phase_child(number: int) -> int:
    """``--phase-<number>``: phase 14 or 15 alone, in a process of its own
    (the kernel library already built; phase 14 reads phase 7's tree).
    Prints its lines, then one JSON line of its K1 launches and
    findings."""
    from skelsplat_tpu_torch.ops import _build
    from skelsplat_tpu_torch.tools.timing import card_line

    _build.build()
    _build.load_library()
    card = card_line()
    if number == 14:
        chain_batch, split, out = phase_prepare(card)
        launches = {"launches_chain_batch": chain_batch,
                    "launches_chained_split": split}
    else:
        runs, out = phase_bench(card)
        launches = {"launches_bench": runs.pop("default"),
                    "launches_bench_runs": runs}
    print(json.dumps({f"phase{number}": {**launches, "findings": out}}),
          flush=True)
    return 0


def phase_in_child(number: int, timeout: int):
    """Phase ``number`` through ``--phase-<number>`` in a child process,
    which has never run torch.profiler: a profiler session leaves the
    profiling hooks on in its process, and every graph replay launch there
    costs ~10x its host time (phases 5 and 12 profile). Returns the
    child's JSON line; a child that fails fails the phase."""
    import subprocess

    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           f"--phase-{number}"], capture_output=True,
                          text=True, timeout=timeout)
    key = f'{{"phase{number}"'
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith(key):
            print(line, flush=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise RuntimeError(f"phase {number}'s process exited "
                           f"{proc.returncode}")
    return json.loads([ln for ln in lines
                       if ln.startswith(key)][-1])[f"phase{number}"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one frame with torch.profiler")
    for number in (14, 15):
        ap.add_argument(f"--phase-{number}", action="store_true",
                        help=f"run phase {number} alone (the full run "
                             f"starts it so, in a process that has not "
                             f"profiled)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if args.phase_14 or args.phase_15:
        return phase_child(14 if args.phase_14 else 15)

    from skelsplat_tpu_torch.ops import _build

    from skelsplat_tpu_torch.tools.timing import card_line

    print("[1/15] build", flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"  {lib_path.name}: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'reused'})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")
    for grad in (True, False):
        for l1 in (False, True):
            for ns in ((16, 24, 32) if grad else (32,)):
                occ = _build.occupancy(grad, l1, ns)
                print(f"  {'K1' if grad else 'K2'} tile kernel, "
                      f"{'l1' if l1 else 'l2'}, slot bound {ns}: "
                      f"{occ['registers']} registers, {occ['local_bytes']} "
                      f"spill bytes a thread, {occ['blocks_per_sm']} resident "
                      f"blocks of 256 per SM", flush=True)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"  card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    print("[2/15] kernels against their plain versions", flush=True)
    rows, step_rows, timed, timed_b = phase_kernels()

    print("[3/15] path: one H36M frame through SceneTrainer.optimize_scene",
          flush=True)
    counts, s_per_frame, (e0, e1) = phase_path(args.profile)
    for row in rows + step_rows:
        row["launches"] = counts[row["name"]]
    print(f"  {s_per_frame:.6f} s/frame (median of {TIMED_FRAMES}; "
          f"{ITERATIONS} iterations, 4 views at {W}x{H}) on {card}",
          flush=True)

    print("[4/15] renderer agreement: cuda vs fused", flush=True)
    phase_agree()

    print("[5/15] measurement path: K3, roofline, kernel_probe, "
          "trace_summary", flush=True)
    k1, k2 = rows
    k3_row, k1_bound, k2_bound, k1_bound_b = phase_measure(
        lib_path, k1["ms"], timed, timed_b)
    for row, (ms, by) in ((k1, k1_bound), (k2, k2_bound)):
        row["bound_ms_measured_rate"], row["bound_by_measured_rate"] = ms, by
    k1["bound_ms_measured_rate_v32"], k1["bound_by_measured_rate_v32"] = \
        k1_bound_b
    rows.append(k3_row)

    print("[6/15] cli: train.main and eval.main over a synthetic H36M tree",
          flush=True)
    cli_counts, s_per_scene, cli_res = phase_cli()
    k1["launches_cli"] = cli_counts["raster_loss_grad"]
    print(f"  {s_per_scene:.6f} s/scene (train_summary.json "
          f"mean_seconds_per_scene; {CLI_SCENES} scenes, {ITERATIONS} "
          f"iterations, 4 views at {W}x{H}, save_images) on {card}",
          flush=True)

    print("[7/15] batch: train.main at scene_batch 1 and 8 over a 10-scene "
          "synthetic H36M tree", flush=True)
    batch_counts, _, _ = phase_batch(card, args.profile)
    k1["launches_batch"] = batch_counts["raster_loss_grad"]

    print("[8/15] options: Panoptic and Occlusion-Person sweeps, the dense "
          "soft-argmax path, confidence-weighted fusion, triangulation, "
          "render", flush=True)
    fields, k1_err, dense_mpjpe = phase_options(card)
    k1.update(fields)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_err)

    print("[9/15] extras: eval.image_metrics (SSIM, LPIPS) card vs CPU, "
          "bench_ssim, the native PLY codec, GaussianModel", flush=True)
    t0 = time.perf_counter()
    extras = phase_extras(card)
    print(f"  phase 9: {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(extras)}", flush=True)

    print("[10/15] multichip: multichip_optimize on NCCL against the batch, "
          "the CLI on 2 ranks, dryrun_multichip, parity_study", flush=True)
    t0 = time.perf_counter()
    k1["launches_multichip"], multichip = phase_multichip(card, cli_res,
                                                          s_per_scene)
    print(f"  phase 10: {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(multichip)}", flush=True)

    print("[11/15] tools: fused initial guesses on the card, a sweep from "
          "them, the triangulation guesses", flush=True)
    t0 = time.perf_counter()
    k1["launches_tools"], tools = phase_tools(card)
    print(f"  phase 11: {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(tools)}", flush=True)

    print("[12/15] graphs: captured against eager (a frame, the chained "
          "CLI sweep against the serial one, the batched sweep)", flush=True)
    t0 = time.perf_counter()
    graphs = phase_graphs(card, s_per_scene)
    k1["launches_captured_frame"] = graphs["a"]["k1_records_profiler"]
    print(f"  phase 12: {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(graphs)}", flush=True)

    print("[13/15] renderers: the dense and fused scenes captured against "
          "eager, the graft entry", flush=True)
    t0 = time.perf_counter()
    renderers = phase_renderers(card, dense_mpjpe)
    print(f"  phase 13: {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(renderers)}", flush=True)

    print("[14/15] prepare: the chain and the batch with no host wait, the "
          "vectorized prepare, the prepare programs, a chained sweep's "
          "split", flush=True)
    t0 = time.perf_counter()
    child = phase_in_child(14, PHASE14_TIMEOUT_S)
    k1["launches_chain_batch"] = child["launches_chain_batch"]
    k1["launches_chained_split"] = child["launches_chained_split"]
    s_chain = graphs["b"]["s_per_scene_chained"]
    s_frame = graphs["a"]["s_per_frame_captured"]
    print(f"  in this process (after the profiler of phases 5 and 12): "
          f"phase 12 (b)'s chained sweep {s_chain:.6f} s/scene against "
          f"phase 12 (a)'s captured frame {s_frame:.6f} s/frame: "
          f"{s_chain / s_frame:.4f}x on {card}", flush=True)
    print(f"  phase 14: {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(child['findings'])}", flush=True)

    print("[15/15] bench: python -m skelsplat_tpu_torch.bench's runs (the "
          "defaults, the other presets, a batch, a profile)", flush=True)
    t0 = time.perf_counter()
    child = phase_in_child(15, PHASE15_TIMEOUT_S)
    k1["launches_bench"] = child["launches_bench"]
    k1["launches_bench_runs"] = child["launches_bench_runs"]
    print(f"  phase 15: {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(child['findings'])}", flush=True)

    # every path's launch counts were asserted equal for K1, A and B
    # (_step_launches); the profiled frame's are K1's kernel records.
    # Kernel C's are K1's but where the routing keeps the torch composite
    # (confidence-weighted fusion; the early stopping of phase 12 (b) and
    # of phase 14 (a)'s chain and batch) and where a renderer with no K1
    # steps (phases 8 (c) and 13's scenes)
    for row in step_rows:
        row.update({k: v for k, v in k1.items() if k.startswith("launches_")
                    and k != "launches_captured_frame"})
        if row["name"] == "compose_adam":
            row.update(launches_fusion=0, launches_chain_batch=0,
                       launches_dense=ITERATIONS // 4,
                       launches_fused=ITERATIONS // 4)
    rows += step_rows
    print(card)
    print(json.dumps({
        "kernels": [r for r in rows if r["name"] in PATH_KERNELS],
        "off_path_kernels": [r for r in rows
                             if r["name"] not in PATH_KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
