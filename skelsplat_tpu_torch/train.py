"""Per-scene skeletal-Gaussian optimization over a dataset tree: the port's
``train`` entry point (counterpart of the root ``train.py``).

    python -m skelsplat_tpu_torch.train --config-name h36m.yaml \
        [--device cuda|cpu] [group.key=value ...]

e.g. ``... --config-name h36m.yaml dataset.end_scene_id=10``. The configs
resolve against ``skelsplat_tpu_torch/config/configs``. Outputs go to the
run dir ``experiments/<ds>/<date>/<time>`` (``hydra.run.dir``). It runs on
the GPU unless ``--device cpu`` is given.

On several GPUs, one process per card under torchrun:

    torchrun --nproc_per_node=K -m skelsplat_tpu_torch.train \
        --config-name h36m.yaml training.multichip=true [...]

shards the sweep over a (scenes × views) mesh of the K ranks
(``parallel/mesh.py``; NCCL when each rank has a card of its own, gloo
otherwise, ``parallel/launch.py``). Rank 0 prints and writes the run;
the other ranks print and write nothing.
"""

import argparse
import logging
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config-name", default="config",
                        help="config YAML under skelsplat_tpu_torch/config/"
                             "configs (or a path)")
    parser.add_argument("--config-path", default=None,
                        help="alternative config directory")
    parser.add_argument("--device", default="cuda",
                        help="torch device to optimize on (default cuda)")
    parser.add_argument("overrides", nargs="*",
                        help="hydra-style group.key=value overrides")
    args = parser.parse_args(argv)

    from skelsplat_tpu_torch.config import ConfigHandler, load_config
    from skelsplat_tpu_torch.data.loader import DataLoader
    from skelsplat_tpu_torch.engine import driver
    from skelsplat_tpu_torch.parallel import launch
    from skelsplat_tpu_torch.utils import safe_state

    with launch.process_group(args.device) as device:
        rank0 = launch.rank() == 0
        cfg = load_config(args.config_name, args.overrides,
                          config_dir=args.config_path, make_run_dir=rank0)
        config = ConfigHandler(cfg)
        output_dir = config.hydra_out

        dataset = cfg.dataset
        train = cfg.training

        if rank0:
            print(output_dir)
        logging.basicConfig(level=logging.INFO if rank0 else logging.ERROR)
        log = logging.getLogger(__name__)

        if train.dropout and rank0:
            print("Dropping out some gt joints during training")

        initial_guess_path = os.path.join(dataset.data_root, "initial_guess",
                                          dataset.initial_guess)
        poses_2d_path = os.path.join(dataset.data_root,
                                     "2d_" + dataset.poses_2d)

        dataset_loader = DataLoader(
            dataset.data_root, initial_guess_path, poses_2d_path,
            frame_step=dataset.frame_step, start_id=dataset.start_scene_id,
            end_id=dataset.end_scene_id, nviews=dataset.nviews)

        generator = safe_state(train.quiet or not rank0)
        return driver.training(dataset, cfg.model, cfg.optimization,
                               cfg.pipeline, cfg.debug, train,
                               dataset_loader, output_dir, generator, log,
                               device=device)

if __name__ == "__main__":
    main()
