"""MPJPE evaluation over saved result clouds: the port's ``eval`` entry
point (counterpart of the root ``eval.py``).

    python -m skelsplat_tpu_torch.eval --config-name h36m.yaml \
        [--device cuda|cpu] [eval.output_path=experiments/h36m/<date>/<time>] \
        [overrides ...]

``eval.output_path=<run dir>`` points at a run; without it the newest run
dir of the config's template is used. MPJPE is numpy on the host.
``eval.image_metrics=true`` also renders each scene's final splats on
``--device`` (default cuda) and reports SSIM against the GT heatmaps, and
LPIPS when weights are given (``eval.lpips_weights=<npz>``) or committed
under ``skelsplat_tpu_torch/ops/lpips_weights/``; ``eval.lpips_net`` picks
vgg (default), alex or squeeze. The returned dict then also holds the
image metrics under "image_metrics".
"""

import argparse
import os

EVAL_KEYS = ("eval.output_path", "eval.image_metrics", "eval.lpips_weights",
             "eval.lpips_net")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config-name", default="configs")
    parser.add_argument("--config-path", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from skelsplat_tpu_torch import resolve_device
    from skelsplat_tpu_torch.config import (latest_run_dir, load_config,
                                            parse_overrides)
    from skelsplat_tpu_torch.evaluation import evaluate

    dev = resolve_device(args.device)
    ovr = parse_overrides(args.overrides)
    output_path = ovr.pop("eval.output_path", None)
    image_metrics_on = str(ovr.pop("eval.image_metrics", "false")
                           ).lower() in ("1", "true", "yes")
    lpips_weights = ovr.pop("eval.lpips_weights", None)
    lpips_net = ovr.pop("eval.lpips_net", "vgg")
    remaining = [o for o in args.overrides
                 if o.split("=", 1)[0] not in EVAL_KEYS]

    cfg = load_config(args.config_name, remaining,
                      config_dir=args.config_path, make_run_dir=False)
    dataset = cfg.dataset
    debug = cfg.debug

    if output_path is None:
        output_path = latest_run_dir(cfg)
    print("Evaluating ", output_path)

    gt_path = os.path.join(dataset.data_root, "3d_gt")
    iterations = list(debug.save_iterations)
    results = evaluate(gt_path, output_path, iterations,
                       dataset.start_scene_id, dataset.end_scene_id,
                       dataset.poses_2d == "cpn", nviews=dataset.nviews)

    if image_metrics_on:
        from skelsplat_tpu_torch.data.loader import DataLoader
        from skelsplat_tpu_torch.evaluation import image_metrics

        loader = DataLoader(
            dataset.data_root,
            os.path.join(dataset.data_root, "initial_guess",
                         dataset.initial_guess),
            os.path.join(dataset.data_root, "2d_" + dataset.poses_2d),
            frame_step=dataset.frame_step, start_id=dataset.start_scene_id,
            end_id=dataset.end_scene_id, nviews=dataset.nviews)
        results["image_metrics"] = image_metrics(
            loader, output_path, scaling=float(cfg.model.scaling),
            scaling_modifier=float(cfg.model.scaling_modifier),
            lpips_net=lpips_net, lpips_weights=lpips_weights, device=dev)
    return results


if __name__ == "__main__":
    main()
