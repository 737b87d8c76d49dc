"""Runs of the mesh path on local ranks (counterpart of
``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` spawns ``n`` local ranks (sharing the card, or
gloo ranks on the CPU with ``device="cpu"``) and runs a full optimization
on the (scenes × views) mesh ``choose_mesh`` gives them, with early
stopping on and scene 0 doctored 1e7 mm along z, where every splat is
culled and its loss stays constant: it must stop at iteration 8 while the other scenes run all 16.
The kernel renderer ("cuda", its plain version on the CPU) must agree
with the autograd row-chunk stream ("fused").

``optimize_jobs`` runs ``multichip_optimize`` for a list of jobs on the
ranks of one group and saves each job's results, so that one group of
spawned ranks can serve several meshes and settings.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

W, H = 96, 80
ITERATIONS = 16
STOP_AT = 8


def _numpy_result(params, hist) -> dict:
    return {"xyz": params.xyz.cpu().numpy(),
            "log_scales": params.log_scales.cpu().numpy(),
            "quats": params.quats.cpu().numpy(),
            "opacity_logit": params.opacity_logit.cpu().numpy(),
            "losses": hist.losses.cpu().numpy(),
            "error": hist.error.cpu().numpy(),
            "stopped_at": hist.stopped_at.cpu().numpy()}


def optimize_jobs(jobs, out_path: str, device="cuda"):
    """Run each job on this process group (every rank calls it with the
    same jobs; ``parallel.launch.spawn`` starts them). A job is a dict:
    ``mesh`` (scenes_axis, views_axis), ``settings`` and ``opt`` (keyword
    arguments of ``TrainSettings`` and ``OptConfig``), ``scene_type``,
    ``scaling``, ``width``, ``height``, ``renderer``, the inputs
    ``initial`` (B,N,3), ``poses_2d`` (B,V,N,2), ``gt`` (B,N,3), ``drop``
    (B,V,N) or None and ``cameras``, a mapping of (B, V) numpy Camera
    fields. Rank 0 saves job i's results under keys ``"{i}/{name}"`` of
    the npz ``out_path``."""
    import torch

    from skelsplat_tpu_torch.core.cameras import camera_from_arrays
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings
    from skelsplat_tpu_torch.parallel import launch
    from skelsplat_tpu_torch.parallel.mesh import (make_mesh,
                                                   multichip_optimize)

    with launch.process_group(device) as dev:
        out = {}
        for i, job in enumerate(jobs):
            mesh = make_mesh(*job["mesh"], device_type=dev.type)
            n_joints = job["initial"].shape[1]
            trainer = SceneTrainer(
                SkeletonModel(job["scene_type"], n_joints,
                              scaling=job["scaling"]),
                OptConfig(**job["opt"]), TrainSettings(**job["settings"]),
                job["width"], job["height"], renderer=job["renderer"],
                device=dev)
            params, hist = multichip_optimize(
                mesh, trainer, job["initial"], job["poses_2d"],
                camera_from_arrays(job["cameras"], device="cpu"), job["gt"],
                drop_b=job["drop"])
            out.update({f"{i}/{k}": v
                        for k, v in _numpy_result(params, hist).items()})
        if launch.rank() == 0:
            np.savez(out_path, **out)
        torch.distributed.barrier()


def _dryrun_rank(device, out_path: str):
    """One rank of ``dryrun_multichip``; rank 0 checks the results and
    writes a summary to ``out_path``."""
    from skelsplat_tpu_torch.core.cameras import (camera_from_arrays,
                                                  stack_cameras)
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings
    from skelsplat_tpu_torch.parallel import launch
    from skelsplat_tpu_torch.parallel.mesh import (choose_mesh, make_mesh,
                                                   multichip_optimize)
    from skelsplat_tpu_torch.synthetic import synthetic_inputs

    with launch.process_group(device) as dev:
        shape = choose_mesh(launch.world_size(), 4)
        mesh = make_mesh(*shape, device_type=dev.type)
        # two scenes a scenes shard, so a doctored and a normal scene run
        # side by side whatever the mesh
        init, gt, p2d, cams_np = synthetic_inputs(2 * shape[0], W, H)
        init[0, :, 2] += 1e7
        cams_b = stack_cameras([camera_from_arrays(cams_np, "cpu")]
                               * len(init))
        results = {}
        for renderer in ("cuda", "fused"):
            trainer = SceneTrainer(
                SkeletonModel("h36m", 17, scaling=3.0),
                OptConfig(iterations=ITERATIONS),
                TrainSettings(early_stopping="opt_early_stopping",
                              consistency_loss="none"),
                W, H, renderer=renderer, device=dev)
            params, hist = multichip_optimize(mesh, trainer, init, p2d,
                                              cams_b, gt)
            res = _numpy_result(params, hist)
            if not (np.isfinite(res["losses"]).all()
                    and np.isfinite(res["xyz"]).all()):
                raise FloatingPointError(f"{renderer}: non-finite results")
            stops = res["stopped_at"].astype(int)
            if stops[0] != STOP_AT or (stops[1:] != 0).any():
                raise AssertionError(
                    f"{renderer}: stops {stops.tolist()}, want scene 0 at "
                    f"{STOP_AT} and no other")
            results[renderer] = res
        a, b = results["cuda"], results["fused"]
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(a["xyz"], b["xyz"], rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(a["stopped_at"], b["stopped_at"])
        if launch.rank() == 0:
            with open(out_path, "w") as f:
                json.dump({
                    "mesh": list(shape), "scenes": len(init),
                    "stopped_at": a["stopped_at"].tolist(),
                    "loss_mean": float(a["losses"].mean()),
                    "max_abs_dxyz": float(np.abs(a["xyz"] - b["xyz"]).max()),
                    "max_abs_dloss": float(
                        np.abs(a["losses"] - b["losses"]).max())}, f)


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """The mesh path on ``n_ranks`` spawned local ranks, on ``device``
    ("cuda", the ranks sharing the host's cards by the backend rule of
    ``parallel.launch``, or "cpu"); raises if a check fails. Returns
    rank 0's summary: the mesh, the stops, the mean loss and the largest
    cuda-vs-fused differences."""
    from skelsplat_tpu_torch import resolve_device
    from skelsplat_tpu_torch.parallel import launch

    resolve_device(device)      # raises here, before any rank starts
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dryrun.json")
        launch.spawn(n_ranks, _dryrun_rank, device, out)
        with open(out) as f:
            summary = json.load(f)
    print(f"dryrun_multichip: mesh {tuple(summary['mesh'])} ok (cuda == "
          f"fused, stop crossed at iteration {summary['stopped_at'][0]}), "
          f"losses {summary['loss_mean']:.5f}")
    return summary
