"""Multi-GPU sharding of the scene sweep over a (scenes × views) mesh of
ranks (counterpart of ``skelsplat_tpu/parallel``)."""

from skelsplat_tpu_torch.parallel.mesh import (batch_scene_records,
                                               choose_mesh, make_mesh,
                                               multichip_programs,
                                               multichip_train_step)

__all__ = ["choose_mesh", "make_mesh", "multichip_train_step",
           "multichip_programs", "batch_scene_records"]
