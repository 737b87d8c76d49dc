#!/usr/bin/env python
"""Per-image mono-depth scale/offset estimation from a COLMAP sparse model
(counterpart of ``skelsplat_tpu/tools/make_depth_scale.py``: vestigial
upstream-3DGS depth tooling).

Aligns inverse monocular depth maps to the COLMAP sparse depths by robust
median/MAD matching and writes ``sparse/0/depth_params.json``.
"""

import argparse
import json
import os

import numpy as np

from skelsplat_tpu_torch.data import colmap


def read_model(path, ext=".bin"):
    if ext == ".bin":
        cams = colmap.read_intrinsics_binary(os.path.join(path, "cameras" + ext))
        imgs = colmap.read_extrinsics_binary(os.path.join(path, "images" + ext))
        xyzs, rgbs, errs = colmap.read_points3D_binary(
            os.path.join(path, "points3D" + ext))
    else:
        cams = colmap.read_intrinsics_text(os.path.join(path, "cameras" + ext))
        imgs = colmap.read_extrinsics_text(os.path.join(path, "images" + ext))
        xyzs, rgbs, errs = colmap.read_points3D_text(
            os.path.join(path, "points3D" + ext))
    return cams, imgs, xyzs


def get_scales(key, cameras, images_metas, points3d_ordered, depths_dir):
    import cv2

    image_meta = images_metas[key]
    cam_intrinsic = cameras[image_meta.camera_id]
    pts_idx = image_meta.point3D_ids
    mask = (pts_idx >= 0) & (pts_idx < len(points3d_ordered))
    pts_idx = pts_idx[mask]
    valid_xys = image_meta.xys[mask]
    pts = points3d_ordered[pts_idx] if len(pts_idx) else np.array([[0, 0, 0.0]])

    R = colmap.qvec2rotmat(image_meta.qvec)
    pts = pts @ R.T + image_meta.tvec
    invcolmapdepth = 1.0 / pts[..., 2]
    n_remove = len(image_meta.name.split(".")[-1]) + 1
    stem = image_meta.name[:-n_remove]
    invmono = cv2.imread(f"{depths_dir}/{stem}.png", cv2.IMREAD_UNCHANGED)
    if invmono is None:
        return None
    if invmono.ndim != 2:
        invmono = invmono[..., 0]
    invmono = invmono.astype(np.float32) / (2 ** 16)
    s = invmono.shape[0] / cam_intrinsic.height

    maps = (valid_xys * s).astype(np.float32)
    valid = ((maps[..., 0] >= 0) & (maps[..., 1] >= 0)
             & (maps[..., 0] < cam_intrinsic.width * s)
             & (maps[..., 1] < cam_intrinsic.height * s)
             & (invcolmapdepth > 0))
    if valid.sum() > 10 and (invcolmapdepth.max()
                             - invcolmapdepth.min()) > 1e-3:
        maps = maps[valid, :]
        invcolmapdepth = invcolmapdepth[valid]
        invmonod = cv2.remap(invmono, maps[..., 0], maps[..., 1],
                             interpolation=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_REPLICATE)[..., 0]
        t_colmap = np.median(invcolmapdepth)
        s_colmap = np.mean(np.abs(invcolmapdepth - t_colmap))
        t_mono = np.median(invmonod)
        s_mono = np.mean(np.abs(invmonod - t_mono))
        scale = s_colmap / s_mono
        offset = t_colmap - t_mono * scale
    else:
        scale = offset = 0
    return {"image_name": stem, "scale": float(scale),
            "offset": float(offset)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--base_dir", required=True)
    parser.add_argument("--depths_dir", required=True)
    parser.add_argument("--model_type", default="bin")
    args = parser.parse_args(argv)

    cams, imgs, pts_xyzs = read_model(
        os.path.join(args.base_dir, "sparse", "0"), ext=f".{args.model_type}")
    # points3D readers return ordered arrays already
    points3d_ordered = pts_xyzs

    out = {}
    for key in imgs:
        dp = get_scales(key, cams, imgs, points3d_ordered, args.depths_dir)
        if dp is not None:
            out[dp["image_name"]] = {"scale": dp["scale"],
                                     "offset": dp["offset"]}
    with open(os.path.join(args.base_dir, "sparse/0/depth_params.json"),
              "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {len(out)} depth params")


if __name__ == "__main__":
    main()
