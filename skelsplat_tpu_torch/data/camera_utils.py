"""Camera-list construction (counterpart of
``skelsplat_tpu/data/camera_utils.py``).

The pose datasets carry no images, so a camera keeps its (width, height);
a ``resolution`` setting in [1, 2, 4, 8], or an explicit target width,
rescales the intrinsics as upstream 3DGS does for image datasets.
"""

from __future__ import annotations

from skelsplat_tpu_torch.core.cameras import Camera, make_camera
from skelsplat_tpu_torch.data.cameras_io import CameraInfo, camera_to_json


def loadCam(args, id, cam_info: CameraInfo, resolution_scale,
            is_nerf_synthetic=False, device="cuda") -> Camera:
    """A ``Camera`` on ``device`` from ``cam_info``, at the resolution
    that ``args.resolution`` (default -1: as recorded) and
    ``resolution_scale`` give."""
    orig_w, orig_h = cam_info.width, cam_info.height
    resolution_setting = getattr(args, "resolution", -1)

    if resolution_setting in [1, 2, 4, 8]:
        scale = resolution_scale * resolution_setting
        resolution = (round(orig_w / scale), round(orig_h / scale))
    else:
        if resolution_setting == -1:
            global_down = 1
        else:
            global_down = orig_w / resolution_setting
        scale = float(global_down) * float(resolution_scale)
        resolution = (int(orig_w / scale), int(orig_h / scale))

    K = cam_info.K.copy()
    if resolution != (orig_w, orig_h):
        K[0, :] *= resolution[0] / orig_w
        K[1, :] *= resolution[1] / orig_h

    return make_camera(cam_info.R, cam_info.T, K, resolution[0],
                       resolution[1], uid=id, device=device)


def cameraList_from_camInfos(cam_infos, resolution_scale, args,
                             is_nerf_synthetic=False, device="cuda"):
    """``loadCam`` of each record, uid = its list position."""
    return [loadCam(args, idx, c, resolution_scale, is_nerf_synthetic,
                    device=device)
            for idx, c in enumerate(cam_infos)]


def camera_to_JSON(id, camera: CameraInfo):
    """One cameras.json entry (``cameras_io.camera_to_json``)."""
    return camera_to_json(id, camera)
