"""Render saved per-scene result clouds to PNG images: the port's
``render`` entry point (counterpart of the root ``render.py``).

    python -m skelsplat_tpu_torch.render --config-name h36m.yaml \
        [--device cuda|cpu] eval.output_path=<run dir> \
        [render.iteration=500] [render.max_scenes=4] [overrides ...]

It reads ``iteration_{it}`` PLYs of the run, renders every view of a scene
in one batched call on the device and writes each view's channel-summed,
min-max normalized image as ``<run>/renders/{scene}_cam{v}.png``. Without
``eval.output_path`` the newest run dir of the config's template is used.
It runs on the GPU unless ``--device cpu`` is given.
"""

import argparse
import os

RENDER_KEYS = ("eval.output_path", "render.iteration", "render.max_scenes")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config-name", default="config")
    parser.add_argument("--config-path", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (default cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from PIL import Image

    from skelsplat_tpu_torch import compat, resolve_device
    from skelsplat_tpu_torch.config import (latest_run_dir, load_config,
                                            parse_overrides)
    from skelsplat_tpu_torch.data import cameras_io, ply
    from skelsplat_tpu_torch.data.loader import DataLoader
    from skelsplat_tpu_torch.engine.driver import render_u8

    device = resolve_device(args.device)
    ovr = parse_overrides(args.overrides)
    output_path = ovr.pop("eval.output_path", None)
    iteration = int(ovr.pop("render.iteration", 500))
    max_scenes = int(ovr.pop("render.max_scenes", 4))
    remaining = [o for o in args.overrides
                 if o.split("=", 1)[0] not in RENDER_KEYS]

    cfg = load_config(args.config_name, remaining,
                      config_dir=args.config_path, make_run_dir=False)
    dataset = cfg.dataset
    if output_path is None:
        output_path = latest_run_dir(cfg)

    loader = DataLoader(
        dataset.data_root,
        os.path.join(dataset.data_root, "initial_guess",
                     dataset.initial_guess),
        os.path.join(dataset.data_root, "2d_" + dataset.poses_2d),
        frame_step=dataset.frame_step, start_id=dataset.start_scene_id,
        end_id=dataset.end_scene_id, nviews=dataset.nviews)

    ply_dir = os.path.join(output_path, "point_cloud",
                           f"iteration_{iteration}")
    out_dir = os.path.join(output_path, "renders")
    os.makedirs(out_dir, exist_ok=True)

    count = 0
    for _, rec in loader:
        if count >= max_scenes:
            break
        path = os.path.join(ply_dir, f"{rec.scene_name}.ply")
        if not os.path.exists(path):
            continue
        params = compat.params_from_numpy(ply.read_gaussian_ply(path),
                                          device=device)
        cams = cameras_io.build_camera_batch(rec.cameras, device="cpu")
        W, H = int(cams.width.max()), int(cams.height.max())
        ims = render_u8(params, cams.map(lambda x: x.to(device)), W,
                        H).cpu().numpy()
        for v in range(ims.shape[0]):
            Image.fromarray(ims[v]).save(
                os.path.join(out_dir, f"{rec.scene_name}_cam{v}.png"))
        count += 1
    print(f"Rendered {count} scenes to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
