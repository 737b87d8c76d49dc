#!/usr/bin/env python
"""Generate a synthetic dataset in the H36M on-disk layout (counterpart of
``skelsplat_tpu/tools/make_synthetic_dataset.py``, which writes the same
files with the same contents for the same arguments).

Creates the npz tree the DataLoader expects (initial_guess/…,
2d_<detector>/…, 3d_gt/…, camera-parameters.json) from random smooth
skeleton motions projected through a 4-camera rig — enough to exercise
train and eval end to end without the (license-restricted) real
datasets; the fixture of the CLI tests and of chip_smoke.py's CLI phase.

    python -m skelsplat_tpu_torch.tools.make_synthetic_dataset /tmp/synth-h36m \
        --subjects S9 S11 --frames 128 --frame-step 64 [--image-size 256]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from skelsplat_tpu_torch.data.cameras_io import H36M_CAMERAS

ACTIVITIES = ["Directions", "Walking"]


def _size(image_size):
    """(width, height) of an ``image_size`` given as one int (a square
    image) or a (width, height) pair."""
    if isinstance(image_size, (int, np.integer)):
        return int(image_size), int(image_size)
    w, h = image_size
    return int(w), int(h)


def make_rig(n_views=4, img=1000, dist=4500.0, focal_scale=2.3):
    """``n_views`` cameras on a ring looking at the volume, for images of
    ``img`` (an int, or a (width, height) pair: the focal then scales with
    the shorter side)."""
    w, h = _size(img)
    cams = []
    rng = np.random.default_rng(42)
    for v in range(n_views):
        th = 2 * np.pi * v / n_views + 0.45
        pos = np.array([dist * np.cos(th), dist * np.sin(th),
                        1200.0 + 150 * v])
        target = np.array([0.0, 0.0, 900.0])
        z = target - pos
        z /= np.linalg.norm(z)
        up = np.array([0.0, 0.0, -1.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=0)          # world→camera
        t = -R @ pos
        f = focal_scale * min(w, h)
        K = np.array([[f, 0, w / 2 + rng.normal(0, 2)],
                      [0, f * 1.002, h / 2 + rng.normal(0, 2)],
                      [0, 0, 1.0]])
        cams.append((K, R, t))
    return cams


def make_motion(n_frames, n_joints=17, seed=0):
    """Smooth random walk around a canonical skeleton (mm)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 280, (n_joints, 3))
    base[:, 2] = 900 + rng.normal(0, 220, n_joints)
    # symmetric limbs so the consistency prior is meaningful (h36m pairs)
    for a, b in [((12, 13), (15, 16)), ((5, 6), (2, 3))]:
        if max(a + b) >= n_joints:
            continue
        la = np.linalg.norm(base[a[0]] - base[a[1]])
        d = base[b[0]] - base[b[1]]
        base[b[1]] = base[b[0]] - d / np.linalg.norm(d) * la
    drift = np.cumsum(rng.normal(0, 4, (n_frames, 1, 3)), axis=0)
    wiggle = np.cumsum(rng.normal(0, 2.0, (n_frames, n_joints, 3)), axis=0)
    return base[None] + drift + wiggle


def project(K, R, t, pts):
    pc = pts @ R.T + t
    uv = pc[:, :2] / pc[:, 2:3]
    return uv @ K[:2, :2].T + K[:2, 2]


def write_tree(root: str, subjects, frames, frame_step, image_size=1000,
               detector="metrabs", noise_2d=0.7, noise_3d=80.0, seed=0):
    cams = make_rig(img=image_size)
    os.makedirs(os.path.join(root, "initial_guess", "cameras"), exist_ok=True)

    # camera-parameters.json in the H36M schema
    params = {"intrinsics": {}, "extrinsics": {}}
    for name, (K, R, t) in zip(H36M_CAMERAS, cams):
        params["intrinsics"][name] = {
            "calibration_matrix": K.reshape(-1).tolist()}
    if image_size != 1000:
        # synthetic-size override honored by cameras_io.get_h36m_camera
        params["image_sizes"] = {name: [image_size, image_size]
                                 for name in H36M_CAMERAS}
    for s in subjects:
        params["extrinsics"][s] = {}
        for name, (K, R, t) in zip(H36M_CAMERAS, cams):
            params["extrinsics"][s][name] = {
                "R": R.tolist(), "t": t.reshape(3, 1).tolist()}
    with open(os.path.join(root, "initial_guess", "cameras",
                           "camera-parameters.json"), "w") as f:
        json.dump(params, f)

    rng = np.random.default_rng(seed)
    for si, subject in enumerate(subjects):
        for ai, activity in enumerate(ACTIVITIES):
            gt = make_motion(frames, seed=seed + 31 * si + 7 * ai)
            sub = gt[::1]  # full-rate GT tree; loader subsamples
            d3 = os.path.join(root, "3d_gt", subject, activity)
            os.makedirs(d3, exist_ok=True)
            np.savez(os.path.join(d3, "poses.npz"), poses=sub)

            # initial guess at the loader's frame_step cadence
            init = gt[::frame_step] + rng.normal(
                0, noise_3d, gt[::frame_step].shape)
            dig = os.path.join(root, "initial_guess", detector, subject,
                               activity)
            os.makedirs(dig, exist_ok=True)
            np.savez(os.path.join(dig, "poses.npz"), poses=init)

            # per-camera 2D detections (subsampled like the guesses)
            for name, (K, R, t) in zip(H36M_CAMERAS, cams):
                p2 = np.stack([project(K, R, t, f) for f in gt[::frame_step]])
                p2 = p2 + rng.normal(0, noise_2d, p2.shape)
                d2 = os.path.join(root, "2d_" + detector, subject, activity,
                                  name)
                os.makedirs(d2, exist_ok=True)
                np.savez(os.path.join(d2, "poses.npz"), poses=p2)
    n_scenes = len(subjects) * len(ACTIVITIES) * len(range(0, frames,
                                                           frame_step))
    return n_scenes


def write_panoptic_tree(root: str, activities=("171204_pose5",
                                               "171204_pose6"),
                        frames=8, image_size=256, nviews=4,
                        detector="metrabs", noise_2d=0.7, noise_3d=60.0,
                        seed=0):
    """Panoptic-layout synthetic tree: S0/<activity> with per-activity
    calibration jsons, poses_filtered_{nviews} files, 19 joints, cm-unit t
    in the calibration (the loader multiplies by 10). ``image_size`` is an
    int (square images) or a (width, height) pair; (1920, 1080), the real
    cameras' size, is the loader's default and is not written."""
    import json as _json

    from skelsplat_tpu_torch.data.cameras_io import PANOPTIC_CAMERAS

    rng = np.random.default_rng(seed)
    cams = make_rig(n_views=max(nviews, 4), img=image_size)
    cam_dir = os.path.join(root, "3d_gt", "cameras")
    os.makedirs(cam_dir, exist_ok=True)
    ig_root = os.path.join(root, "initial_guess", "triang_" + detector)

    for ai, activity in enumerate(activities):
        cal = {"cameras": []}
        if image_size != 1080 and _size(image_size) != (1920, 1080):
            cal["image_size"] = list(_size(image_size))
        for name, (K, R, t) in zip(PANOPTIC_CAMERAS, cams):
            cal["cameras"].append({
                "name": name, "K": K.tolist(), "R": R.tolist(),
                # stored in cm; loader scales ×10 to mm
                "t": (t / 10.0).reshape(3, 1).tolist(),
                "distCoef": [0, 0, 0, 0, 0]})
        with open(os.path.join(cam_dir,
                               f"calibration_{activity}.json"), "w") as f:
            _json.dump(cal, f)

        gt = make_motion(frames, n_joints=19, seed=seed + ai)
        d3 = os.path.join(root, "3d_gt", "S0", activity)
        os.makedirs(d3, exist_ok=True)
        np.savez(os.path.join(d3, f"poses_filtered_{nviews}.npz"), poses=gt)

        init = gt + rng.normal(0, noise_3d, gt.shape)
        dig = os.path.join(ig_root, "S0", activity)
        os.makedirs(dig, exist_ok=True)
        np.savez(os.path.join(dig, "poses.npz"), poses=init)

        for name, (K, R, t) in zip(PANOPTIC_CAMERAS[:nviews], cams):
            p2 = np.stack([project(K, R, t, f) for f in gt])
            p2 = p2 + rng.normal(0, noise_2d, p2.shape)
            d2 = os.path.join(root, "2d_" + detector, "S0", activity, name)
            os.makedirs(d2, exist_ok=True)
            np.savez(os.path.join(d2, f"poses_filtered_{nviews}.npz"),
                     poses=p2)
    return len(activities) * frames


def write_occlusion_person_tree(root: str, frames=8, image_size=256,
                                detector="resnet", noise_2d=0.7,
                                noise_3d=60.0, seed=0):
    """Occlusion-Person layout: S0/validation, 8 cameras '0'..'7' with the
    per-scene cameras.json (fx/fy/cx/cy/R/T with T = camera center so the
    loader's t = −R·T holds), 15 joints. ``image_size`` is an int (square
    images) or a (width, height) pair; (1280, 720), the real cameras'
    size, is the loader's default and is not written."""
    import json as _json

    rng = np.random.default_rng(seed)
    cams = make_rig(n_views=8, img=image_size)
    n_scenes = frames
    cameras_json = {}
    gt = make_motion(frames, n_joints=15, seed=seed)

    for scene_id in range(n_scenes):
        per_scene = []
        for (K, R, t) in cams:
            center = -R.T @ t          # loader: t = −R·T ⇒ T = camera center
            cam_rec = {
                "fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2],
                "R": R.tolist(), "T": center.reshape(3, 1).tolist()}
            if image_size != 720 and _size(image_size) != (1280, 720):
                cam_rec["image_size"] = list(_size(image_size))
            per_scene.append(cam_rec)
        cameras_json[str(scene_id)] = per_scene
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "cameras.json"), "w") as f:
        _json.dump(cameras_json, f)

    d3 = os.path.join(root, "3d_gt", "S0", "validation")
    os.makedirs(d3, exist_ok=True)
    np.savez(os.path.join(d3, "poses.npz"), poses3d=gt)

    init = gt + rng.normal(0, noise_3d, gt.shape)
    dig = os.path.join(root, "initial_guess", "triang_" + detector, "S0",
                       "validation")
    os.makedirs(dig, exist_ok=True)
    np.savez(os.path.join(dig, "poses.npz"), poses3d=init)

    for ci, (K, R, t) in enumerate(cams):
        p2 = np.stack([project(K, R, t, f) for f in gt])
        p2 = p2 + rng.normal(0, noise_2d, p2.shape)
        d2 = os.path.join(root, "2d_" + detector, "S0", "validation",
                          str(ci))
        os.makedirs(d2, exist_ok=True)
        np.savez(os.path.join(d2, "poses.npz"), poses2d=p2)
    return n_scenes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("root")
    ap.add_argument("--subjects", nargs="+", default=["S9", "S11"])
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--frame-step", type=int, default=64)
    ap.add_argument("--image-size", type=int, nargs="+", default=[1000],
                    help="one size (square images) or width and height "
                         "(panoptic and occlusion-person layouts)")
    ap.add_argument("--detector", default="metrabs")
    ap.add_argument("--layout", default="h36m",
                    choices=["h36m", "panoptic", "occlusion-person"])
    args = ap.parse_args(argv)
    if len(args.image_size) > 2 or (len(args.image_size) == 2
                                    and args.layout == "h36m"):
        ap.error("--image-size takes one size, or width and height for the "
                 "panoptic and occlusion-person layouts")
    size = (args.image_size[0] if len(args.image_size) == 1
            else tuple(args.image_size))
    if args.layout == "panoptic":
        n = write_panoptic_tree(args.root, frames=args.frames,
                                image_size=size)
    elif args.layout == "occlusion-person":
        n = write_occlusion_person_tree(args.root, frames=args.frames,
                                        image_size=size)
    else:
        n = write_tree(args.root, args.subjects, args.frames,
                       args.frame_step, size, args.detector)
    print(f"Wrote synthetic {args.layout}-style dataset with {n} scenes "
          f"to {args.root}")


if __name__ == "__main__":
    main()
