"""DLT triangulation of 2D detections into iteration_0 initial-guess
clouds: the port's ``triangulation`` entry point (counterpart of the root
``triangulation.py``).

    python -m skelsplat_tpu_torch.triangulation \
        --config-name triangulation.yaml [--device cuda|cpu] [overrides ...]

The clouds go to ``<run dir>/point_cloud/iteration_0/{scene}.ply``. It runs
on the GPU unless ``--device cpu`` is given.
"""

import argparse
import logging
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config-name", default="config")
    parser.add_argument("--config-path", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to solve on (default cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from skelsplat_tpu_torch import resolve_device
    from skelsplat_tpu_torch.config import (TriangulationConfigHandler,
                                            load_config)
    from skelsplat_tpu_torch.data.loader import DataLoader
    from skelsplat_tpu_torch.triangulate import run_triangulation

    device = resolve_device(args.device)
    cfg = load_config(args.config_name, args.overrides,
                      config_dir=args.config_path)
    config = TriangulationConfigHandler(cfg)
    output_dir = config.hydra_out
    dataset = cfg.dataset

    print(output_dir)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger(__name__)

    initial_guess_path = os.path.join(dataset.data_root, "initial_guess",
                                      dataset.initial_guess)
    poses_2d_path = os.path.join(dataset.data_root, "2d_" + dataset.poses_2d)

    dataset_loader = DataLoader(
        dataset.data_root, initial_guess_path, poses_2d_path,
        frame_step=dataset.frame_step, start_id=dataset.start_scene_id,
        end_id=dataset.end_scene_id, nviews=dataset.nviews)

    run_triangulation(dataset, dataset_loader, output_dir, log, device)
    return output_dir


if __name__ == "__main__":
    main()
