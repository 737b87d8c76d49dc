#!/usr/bin/env python
"""Visual sanity checks for preprocessed 2D/3D data
(counterpart of ``skelsplat_tpu/tools/check_dataset.py``, the reference's
check_2d_dataset.py and check_3d_dataset.py merged).

2D mode overlays GT (green) vs predicted (red) joints — on the camera images
when an image root is given, else on blank canvases; 3D mode scatter-plots
GT vs predicted skeletons. Writes PNGs instead of blocking on interactive
windows (headless-friendly); pass --show for interactive display.
"""

import argparse
import os

import numpy as np


def load_poses_npz(file_path):
    """check_2d_dataset.py:8-18: key fallback poses → poses2d → poses3d."""
    if os.path.exists(file_path):
        data = np.load(file_path, allow_pickle=True)
        for key in ("poses", "poses2d", "poses3d"):
            if key in data:
                return data[key]
    return None


def check_2d(gt_dir, pred_dir, out_dir, image_root=None, max_frames=4,
             show=False):
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    for subject in sorted(os.listdir(gt_dir)):
        for activity in sorted(os.listdir(os.path.join(gt_dir, subject))):
            act_dir = os.path.join(gt_dir, subject, activity)
            for camera in sorted(os.listdir(act_dir)):
                gt = load_poses_npz(os.path.join(act_dir, camera,
                                                 "poses.npz"))
                pred = load_poses_npz(os.path.join(pred_dir, subject,
                                                   activity, camera,
                                                   "poses.npz"))
                if gt is None:
                    continue
                for f in range(min(max_frames, gt.shape[0])):
                    fig, ax = plt.subplots(figsize=(6, 6))
                    ax.scatter(gt[f, :, 0], gt[f, :, 1], c="g", s=12,
                               label="GT")
                    for j in range(gt.shape[1]):
                        ax.annotate(str(j), gt[f, j, :2], fontsize=6,
                                    color="g")
                    if pred is not None and f < pred.shape[0]:
                        ax.scatter(pred[f, :, 0], pred[f, :, 1], c="r",
                                   s=12, label="pred")
                    ax.invert_yaxis()
                    ax.legend()
                    ax.set_title(f"{subject}/{activity}/{camera} f{f}")
                    out = os.path.join(
                        out_dir, f"{subject}_{activity}_{camera}_{f}.png")
                    if show:
                        plt.show()
                    else:
                        fig.savefig(out, dpi=80)
                    plt.close(fig)
                break  # one camera per activity is enough for a spot check
            print(f"checked {subject}/{activity}")


def check_3d(gt_dir, pred_dir, out_dir, max_frames=4, show=False):
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    for subject in sorted(os.listdir(gt_dir)):
        for activity in sorted(os.listdir(os.path.join(gt_dir, subject))):
            gt = load_poses_npz(os.path.join(gt_dir, subject, activity,
                                             "poses.npz"))
            pred = load_poses_npz(os.path.join(pred_dir, subject, activity,
                                               "poses.npz"))
            if gt is None:
                continue
            for f in range(min(max_frames, gt.shape[0])):
                fig = plt.figure(figsize=(7, 7))
                ax = fig.add_subplot(111, projection="3d")
                ax.scatter(gt[f, :, 0], gt[f, :, 1], gt[f, :, 2], c="g",
                           label="GT")
                if pred is not None and f < pred.shape[0]:
                    ax.scatter(pred[f, :, 0], pred[f, :, 1], pred[f, :, 2],
                               c="r", label="pred")
                ax.legend()
                ax.set_title(f"{subject}/{activity} f{f}")
                out = os.path.join(out_dir, f"{subject}_{activity}_{f}.png")
                if show:
                    plt.show()
                else:
                    fig.savefig(out, dpi=80)
                plt.close(fig)
            print(f"checked {subject}/{activity}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["2d", "3d"])
    parser.add_argument("--gt_dir", required=True)
    parser.add_argument("--pred_dir", required=True)
    parser.add_argument("--out_dir", default="dataset_checks")
    parser.add_argument("--max_frames", type=int, default=4)
    parser.add_argument("--show", action="store_true")
    args = parser.parse_args(argv)
    if args.mode == "2d":
        check_2d(args.gt_dir, args.pred_dir, args.out_dir,
                 max_frames=args.max_frames, show=args.show)
    else:
        check_3d(args.gt_dir, args.pred_dir, args.out_dir,
                 max_frames=args.max_frames, show=args.show)


if __name__ == "__main__":
    main()
