"""The program under test, ``skelsplat_tpu_torch``, as the benchmark drives
it: through its public trainer API (``SkeletonModel``, ``OptConfig``,
``TrainSettings``, ``SceneTrainer``, ``stack_cameras``), with result copies
of the benchmark's own. Nothing else of the program is imported here but
the K1 launch counter, which a run prints."""

from __future__ import annotations

import numpy as np
import torch

OPT_KEYS = ("iterations", "position_lr_init", "position_lr_final",
            "position_lr_delay_mult", "position_lr_max_steps", "feature_lr",
            "opacity_lr", "scaling_lr", "rotation_lr")
SETTING_KEYS = ("loss_function", "lambda_loss_function", "consistency_loss",
                "lambda_consistency", "early_stopping", "accumulation_steps",
                "dropout", "std_dev_noise")


def make_trainer(config: dict, device):
    """The configuration's ``SceneTrainer`` on ``device``."""
    from skelsplat_tpu_torch.core.gaussians import SkeletonModel
    from skelsplat_tpu_torch.engine.optim import OptConfig
    from skelsplat_tpu_torch.engine.trainer import SceneTrainer, TrainSettings

    model = SkeletonModel(config["dataset"], config["joints"],
                          scaling=config["scaling"],
                          scaling_modifier=config["scaling_modifier"])
    return SceneTrainer(model,
                        OptConfig(**{k: config[k] for k in OPT_KEYS}),
                        TrainSettings(**{k: config[k] for k in SETTING_KEYS}),
                        config["width"], config["height"], renderer="auto",
                        device=device)


def cameras(fields: dict):
    """The program's batched ``Camera`` of the rig, on the host, where the
    sweep driver keeps it."""
    from skelsplat_tpu_torch.core.cameras import camera_from_arrays

    return camera_from_arrays(fields, "cpu")


def stacked_cameras(cams, n: int):
    """The rig's cameras for ``n`` scenes of a batch: (n, V) fields."""
    from skelsplat_tpu_torch.core.cameras import stack_cameras

    return stack_cameras([cams] * n)


def k1_launches() -> int:
    """The program's count of K1 launches so far in this process."""
    from skelsplat_tpu_torch.ops import cuda_raster

    return int(cuda_raster.launches["raster_loss_grad"])


class Fetch:
    """One host copy of device tensors, started now and read later: packed
    into one float32 tensor and, on a GPU, copied without blocking into
    pinned host memory, an event recorded behind the copy. ``result()``
    waits for that event alone, so work enqueued after the copy is not
    waited for."""

    def __init__(self, tensors):
        self.shapes = [tuple(t.shape) for t in tensors]
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        self.event = None
        if flat.device.type == "cuda":
            self.host = torch.empty(flat.shape, dtype=flat.dtype,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.host = flat.clone()

    def result(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        host = self.host.numpy()
        out, at = [], 0
        for shape in self.shapes:
            n = int(np.prod(shape, dtype=np.int64))
            out.append(host[at:at + n].reshape(shape))
            at += n
        return out
