"""COLMAP sparse-model IO, text and binary (counterpart of
``skelsplat_tpu/data/colmap.py``; numpy only). It serves the upstream-3DGS
Colmap scene reader (``data/scene_readers.py``)."""

from __future__ import annotations

import collections
import os
import struct

import numpy as np

from skelsplat_tpu_torch.core.geometry import qvec2rotmat, rotmat2qvec  # noqa: F401

CameraModel = collections.namedtuple(
    "CameraModel", ["model_id", "model_name", "num_params"])
Camera = collections.namedtuple(
    "Camera", ["id", "model", "width", "height", "params"])
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys",
              "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

CAMERA_MODELS = {
    CameraModel(0, "SIMPLE_PINHOLE", 3), CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4), CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8), CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12), CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


def read_next_bytes(fid, num_bytes, format_char_sequence,
                    endian_character="<"):
    data = fid.read(num_bytes)
    return struct.unpack(endian_character + format_char_sequence, data)


def read_extrinsics_text(path):
    images = {}
    with open(path) as fid:
        while True:
            line = fid.readline()
            if not line:
                break
            line = line.strip()
            if len(line) > 0 and line[0] != "#":
                elems = line.split()
                image_id = int(elems[0])
                qvec = np.array(tuple(map(float, elems[1:5])))
                tvec = np.array(tuple(map(float, elems[5:8])))
                camera_id = int(elems[8])
                image_name = elems[9]
                elems = fid.readline().split()
                xys = np.column_stack([tuple(map(float, elems[0::3])),
                                       tuple(map(float, elems[1::3]))])
                point3D_ids = np.array(tuple(map(int, elems[2::3])))
                images[image_id] = Image(
                    id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                    name=image_name, xys=xys, point3D_ids=point3D_ids)
    return images


def read_intrinsics_text(path):
    cameras = {}
    with open(path) as fid:
        while True:
            line = fid.readline()
            if not line:
                break
            line = line.strip()
            if len(line) > 0 and line[0] != "#":
                elems = line.split()
                camera_id = int(elems[0])
                model = elems[1]
                assert model == "PINHOLE", \
                    "loader only supports undistorted (PINHOLE) datasets"
                width = int(elems[2])
                height = int(elems[3])
                params = np.array(tuple(map(float, elems[4:])))
                cameras[camera_id] = Camera(id=camera_id, model=model,
                                            width=width, height=height,
                                            params=params)
    return cameras


def read_extrinsics_binary(path_to_model_file):
    images = {}
    with open(path_to_model_file, "rb") as fid:
        num_reg_images = read_next_bytes(fid, 8, "Q")[0]
        for _ in range(num_reg_images):
            props = read_next_bytes(fid, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            image_name = b""
            ch = read_next_bytes(fid, 1, "c")[0]
            while ch != b"\x00":
                image_name += ch
                ch = read_next_bytes(fid, 1, "c")[0]
            num_points2D = read_next_bytes(fid, 8, "Q")[0]
            xyi = read_next_bytes(fid, 24 * num_points2D,
                                  "ddq" * num_points2D)
            xys = np.column_stack([tuple(map(float, xyi[0::3])),
                                   tuple(map(float, xyi[1::3]))])
            point3D_ids = np.array(tuple(map(int, xyi[2::3])))
            images[image_id] = Image(
                id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                name=image_name.decode("utf-8"), xys=xys,
                point3D_ids=point3D_ids)
    return images


def read_intrinsics_binary(path_to_model_file):
    cameras = {}
    with open(path_to_model_file, "rb") as fid:
        num_cameras = read_next_bytes(fid, 8, "Q")[0]
        for _ in range(num_cameras):
            props = read_next_bytes(fid, 24, "iiQQ")
            camera_id, model_id = props[0], props[1]
            width, height = props[2], props[3]
            model = CAMERA_MODEL_IDS[model_id]
            params = read_next_bytes(fid, 8 * model.num_params,
                                     "d" * model.num_params)
            cameras[camera_id] = Camera(id=camera_id,
                                        model=model.model_name,
                                        width=width, height=height,
                                        params=np.array(params))
        assert len(cameras) == num_cameras
    return cameras


def read_points3D_text(path):
    xyzs = rgbs = errors = None
    num_points = 0
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if len(line) > 0 and line[0] != "#":
                num_points += 1
    xyzs = np.empty((num_points, 3))
    rgbs = np.empty((num_points, 3))
    errors = np.empty((num_points, 1))
    count = 0
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if len(line) > 0 and line[0] != "#":
                elems = line.split()
                xyzs[count] = np.array(tuple(map(float, elems[1:4])))
                rgbs[count] = np.array(tuple(map(int, elems[4:7])))
                errors[count] = float(elems[7])
                count += 1
    return xyzs, rgbs, errors


def read_points3D_binary(path_to_model_file):
    with open(path_to_model_file, "rb") as fid:
        num_points = read_next_bytes(fid, 8, "Q")[0]
        xyzs = np.empty((num_points, 3))
        rgbs = np.empty((num_points, 3))
        errors = np.empty((num_points, 1))
        for p_id in range(num_points):
            props = read_next_bytes(fid, 43, "QdddBBBd")
            xyzs[p_id] = np.array(props[1:4])
            rgbs[p_id] = np.array(props[4:7])
            errors[p_id] = np.array(props[7])
            track_length = read_next_bytes(fid, 8, "Q")[0]
            read_next_bytes(fid, 8 * track_length, "ii" * track_length)
    return xyzs, rgbs, errors


def write_next_bytes(fid, data, format_char_sequence, endian_character="<"):
    if isinstance(data, (list, tuple)):
        fid.write(struct.pack(endian_character + format_char_sequence, *data))
    else:
        fid.write(struct.pack(endian_character + format_char_sequence, data))


def write_cameras_text(cameras, path):
    """utils/read_write_model.py (vestigial COLMAP model writers)."""
    with open(path, "w") as fid:
        fid.write("# Camera list with one line of data per camera:\n"
                  "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                  f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(str(p) for p in cam.params)
            fid.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                      f"{params}\n")


def write_cameras_binary(cameras, path_to_model_file):
    with open(path_to_model_file, "wb") as fid:
        write_next_bytes(fid, len(cameras), "Q")
        for cam in cameras.values():
            model_id = CAMERA_MODEL_NAMES[cam.model].model_id
            write_next_bytes(fid, [cam.id, model_id, cam.width, cam.height],
                             "iiQQ")
            for p in cam.params:
                write_next_bytes(fid, float(p), "d")


def write_images_text(images, path):
    with open(path, "w") as fid:
        fid.write("# Image list with two lines of data per image:\n"
                  "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, "
                  "NAME\n#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                  f"# Number of images: {len(images)}\n")
        for img in images.values():
            head = [img.id, *img.qvec, *img.tvec, img.camera_id, img.name]
            fid.write(" ".join(map(str, head)) + "\n")
            pts = []
            for xy, p3d in zip(img.xys, img.point3D_ids):
                pts.append(f"{xy[0]} {xy[1]} {p3d}")
            fid.write(" ".join(pts) + "\n")


def write_images_binary(images, path_to_model_file):
    with open(path_to_model_file, "wb") as fid:
        write_next_bytes(fid, len(images), "Q")
        for img in images.values():
            write_next_bytes(fid, img.id, "i")
            write_next_bytes(fid, list(img.qvec), "dddd")
            write_next_bytes(fid, list(img.tvec), "ddd")
            write_next_bytes(fid, img.camera_id, "i")
            fid.write(img.name.encode("utf-8") + b"\x00")
            write_next_bytes(fid, len(img.point3D_ids), "Q")
            for xy, p3d in zip(img.xys, img.point3D_ids):
                write_next_bytes(fid, [float(xy[0]), float(xy[1]),
                                       int(p3d)], "ddq")


def read_colmap_bin_array(path):
    """COLMAP dense depth-map reader (colmap_loader/read_write_model)."""
    with open(path, "rb") as fid:
        width, height, channels = np.genfromtxt(
            fid, delimiter="&", max_rows=1, usecols=(0, 1, 2), dtype=int)
        fid.seek(0)
        num_delimiter = 0
        byte = fid.read(1)
        while True:
            if byte == b"&":
                num_delimiter += 1
                if num_delimiter >= 3:
                    break
            byte = fid.read(1)
        array = np.fromfile(fid, np.float32)
    array = array.reshape((width, height, channels), order="F")
    return np.transpose(array, (1, 0, 2)).squeeze()


# --- Full-model dispatchers (utils/read_write_model.py:427-530) ----------
# The array-returning ``read_points3D_*`` above keep colmap_loader.py's
# interface (xyzs, rgbs, errors) for the 3DGS scene reader; the model-level
# functions below round-trip complete Point3D records including tracks.

def read_points3D_model_text(path):
    points3D = {}
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            pid = int(elems[0])
            track = np.array(tuple(map(int, elems[8:])))
            points3D[pid] = Point3D(
                id=pid, xyz=np.array(tuple(map(float, elems[1:4]))),
                rgb=np.array(tuple(map(int, elems[4:7]))),
                error=np.array(float(elems[7])),
                image_ids=track[0::2], point2D_idxs=track[1::2])
    return points3D


def read_points3D_model_binary(path_to_model_file):
    points3D = {}
    with open(path_to_model_file, "rb") as fid:
        num_points = read_next_bytes(fid, 8, "Q")[0]
        for _ in range(num_points):
            props = read_next_bytes(fid, 43, "QdddBBBd")
            pid = props[0]
            track_length = read_next_bytes(fid, 8, "Q")[0]
            track = read_next_bytes(fid, 8 * track_length,
                                    "ii" * track_length)
            points3D[pid] = Point3D(
                id=pid, xyz=np.array(props[1:4]),
                rgb=np.array(props[4:7]), error=np.array(props[7]),
                image_ids=np.array(tuple(map(int, track[0::2]))),
                point2D_idxs=np.array(tuple(map(int, track[1::2]))))
    return points3D


def write_points3D_text(points3D, path):
    n_tracks = sum(len(pt.image_ids) for pt in points3D.values())
    mean_track = n_tracks / len(points3D) if points3D else 0
    with open(path, "w") as fid:
        fid.write("# 3D point list with one line of data per point:\n"
                  "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as "
                  "(IMAGE_ID, POINT2D_IDX)\n"
                  f"# Number of points: {len(points3D)}, "
                  f"mean track length: {mean_track}\n")
        for pt in points3D.values():
            head = [pt.id, *pt.xyz, *pt.rgb, pt.error]
            track = [f"{i} {j}" for i, j in zip(pt.image_ids,
                                                pt.point2D_idxs)]
            fid.write(" ".join(map(str, head)) + " "
                      + " ".join(track) + "\n")


def write_points3D_binary(points3D, path_to_model_file):
    with open(path_to_model_file, "wb") as fid:
        write_next_bytes(fid, len(points3D), "Q")
        for pt in points3D.values():
            write_next_bytes(fid, int(pt.id), "Q")
            write_next_bytes(fid, [float(v) for v in pt.xyz], "ddd")
            write_next_bytes(fid, [int(v) for v in pt.rgb], "BBB")
            write_next_bytes(fid, float(pt.error), "d")
            write_next_bytes(fid, len(pt.image_ids), "Q")
            for i, j in zip(pt.image_ids, pt.point2D_idxs):
                write_next_bytes(fid, [int(i), int(j)], "ii")


def detect_model_format(path, ext):
    return all(os.path.isfile(os.path.join(path, name + ext))
               for name in ("cameras", "images", "points3D"))


def read_model(path, ext=""):
    if ext == "":
        for candidate in (".bin", ".txt"):
            if detect_model_format(path, candidate):
                ext = candidate
                break
        else:
            raise FileNotFoundError(
                f"No COLMAP model (.bin or .txt) found under {path}")
    join = lambda name: os.path.join(path, name + ext)  # noqa: E731
    if ext == ".txt":
        return (read_intrinsics_text(join("cameras")),
                read_extrinsics_text(join("images")),
                read_points3D_model_text(join("points3D")))
    return (read_intrinsics_binary(join("cameras")),
            read_extrinsics_binary(join("images")),
            read_points3D_model_binary(join("points3D")))


def write_model(cameras, images, points3D, path, ext=".bin"):
    join = lambda name: os.path.join(path, name + ext)  # noqa: E731
    if ext == ".txt":
        write_cameras_text(cameras, join("cameras"))
        write_images_text(images, join("images"))
        write_points3D_text(points3D, join("points3D"))
    else:
        write_cameras_binary(cameras, join("cameras"))
        write_images_binary(images, join("images"))
        write_points3D_binary(points3D, join("points3D"))
    return cameras, images, points3D
