"""SIBR remote-viewer socket protocol (counterpart of
``skelsplat_tpu/network_gui.py``, the reference's
gaussian_renderer/network_gui.py: never imported by its train.py, kept
for upstream-3DGS viewer compatibility).

The same little-endian length-prefixed JSON protocol; the received camera
becomes the port's ``Camera`` (``MiniCam.to_camera``), with the viewer's
sign flips on the view/projection columns undone. The listening socket is
made by ``init``, not on import.
"""

from __future__ import annotations

import json
import socket
import struct
import traceback

import numpy as np

host = "127.0.0.1"
port = 6009

conn = None
addr = None
listener = None


class MiniCam:
    """scene/cameras.py:102-114 — viewer-supplied camera."""

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view_transform, full_proj_transform):
        self.image_width = width
        self.image_height = height
        self.FoVy = fovy
        self.FoVx = fovx
        self.znear = znear
        self.zfar = zfar
        # torch-storage convention: transposed matrices
        self.world_view_transform = np.asarray(world_view_transform)
        self.full_proj_transform = np.asarray(full_proj_transform)
        view_inv = np.linalg.inv(self.world_view_transform)
        self.camera_center = view_inv[3][:3]

    def to_camera(self, device="cuda"):
        """The port's (unbatched) Camera on ``device``."""
        import math

        from skelsplat_tpu_torch.core.cameras import camera_from_arrays

        w2v = self.world_view_transform.T        # back to math convention
        full = self.full_proj_transform.T
        proj = full @ np.linalg.inv(w2v)
        tan_fovx = math.tan(self.FoVx * 0.5)
        tan_fovy = math.tan(self.FoVy * 0.5)
        f32 = np.float32
        return camera_from_arrays(dict(
            view4=w2v.astype(np.float32), proj4=proj.astype(np.float32),
            full4=full.astype(np.float32),
            cam_center=self.camera_center.astype(np.float32),
            focal_x=f32(self.image_width / (2 * tan_fovx)),
            focal_y=f32(self.image_height / (2 * tan_fovy)),
            tan_fovx=f32(tan_fovx), tan_fovy=f32(tan_fovy),
            width=f32(self.image_width), height=f32(self.image_height),
            uid=np.int32(0)), device)


def init(wish_host, wish_port):
    global host, port, listener
    host = wish_host
    port = wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind((host, port))
    listener.listen()
    listener.settimeout(0)


def try_connect():
    global conn, addr, listener
    try:
        conn, addr = listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except Exception:
        pass


def _recv_exact(num_bytes):
    """Read exactly num_bytes (socket.recv may return short chunks)."""
    chunks = []
    remaining = num_bytes
    while remaining > 0:
        chunk = conn.recv(remaining)
        if not chunk:
            raise ConnectionError("viewer closed the socket mid-message")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def read():
    (length,) = struct.unpack("<I", _recv_exact(4))
    return json.loads(_recv_exact(length).decode("utf-8"))


def send(message_bytes, verify):
    tail = verify.encode("ascii")
    payload = b"" if message_bytes is None else bytes(message_bytes)
    conn.sendall(payload + struct.pack("<I", len(tail)) + tail)


def receive():
    message = read()
    width = message["resolution_x"]
    height = message["resolution_y"]
    if width != 0 and height != 0:
        try:
            do_training = bool(message["train"])
            fovy = message["fov_y"]
            fovx = message["fov_x"]
            znear = message["z_near"]
            zfar = message["z_far"]
            do_shs_python = bool(message["shs_python"])
            do_rot_scale_python = bool(message["rot_scale_python"])
            keep_alive = bool(message["keep_alive"])
            scaling_modifier = message["scaling_modifier"]
            wvt = np.reshape(np.asarray(message["view_matrix"],
                                        dtype=np.float32), (4, 4))
            wvt[:, 1] = -wvt[:, 1]
            wvt[:, 2] = -wvt[:, 2]
            fpt = np.reshape(np.asarray(message["view_projection_matrix"],
                                        dtype=np.float32), (4, 4))
            fpt[:, 1] = -fpt[:, 1]
            custom_cam = MiniCam(width, height, fovy, fovx, znear, zfar,
                                 wvt, fpt)
        except Exception as e:
            traceback.print_exc()
            raise e
        return (custom_cam, do_training, do_shs_python,
                do_rot_scale_python, keep_alive, scaling_modifier)
    return None, None, None, None, None, None
