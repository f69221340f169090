"""COLMAP binary model readers (pure numpy/struct; a copy of the JAX
package's `data/colmap_utils.py`).

Capability parity with reference `datasets/colmap_utils.py` (itself the
standard COLMAP scripts): readers for `cameras.bin`, `images.bin`,
`points3D.bin`, dense `.bin` arrays, and quaternion→rotation conversion.
Written against the published COLMAP binary format.
"""

from __future__ import annotations

import collections
import struct

import numpy as np

CameraModel = collections.namedtuple("CameraModel",
                                     ["model_id", "model_name", "num_params"])
Camera = collections.namedtuple("Camera",
                                ["id", "model", "width", "height", "params"])
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z); inverse of
    qvec2rotmat (standard COLMAP convention)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(
        R, np.float64).flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec = -qvec
    return qvec


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


CAMERA_MODELS = {
    CameraModel(0, "SIMPLE_PINHOLE", 3), CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4), CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8), CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12), CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5), CameraModel(10, "THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}


def _read(fid, num_bytes, fmt):
    return struct.unpack("<" + fmt, fid.read(num_bytes))


def read_cameras_binary(path: str) -> dict:
    cameras = {}
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        for _ in range(num):
            cam_id, model_id, width, height = _read(fid, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read(fid, 8 * model.num_params,
                                    "d" * model.num_params))
            cameras[cam_id] = Camera(cam_id, model.model_name, width, height,
                                     params)
    return cameras


def read_images_binary(path: str) -> dict:
    images = {}
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        for _ in range(num):
            vals = _read(fid, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            c = fid.read(1)
            while c != b"\x00":
                name += c
                c = fid.read(1)
            num_pts = _read(fid, 8, "Q")[0]
            data = _read(fid, 24 * num_pts, "ddq" * num_pts)
            xys = np.column_stack([
                np.array(data[0::3]), np.array(data[1::3])])
            ids = np.array(data[2::3])
            images[image_id] = Image(image_id, qvec, tvec, camera_id,
                                     name.decode("utf-8"), xys, ids)
    return images


def read_points3d_binary(path: str) -> dict:
    points = {}
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        for _ in range(num):
            vals = _read(fid, 43, "QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7])
            error = vals[7]
            track_len = _read(fid, 8, "Q")[0]
            track = _read(fid, 8 * track_len, "ii" * track_len)
            image_ids = np.array(track[0::2])
            point2d_idxs = np.array(track[1::2])
            points[pid] = Point3D(pid, xyz, rgb, error, image_ids,
                                  point2d_idxs)
    return points


def read_model(path: str, ext: str = ".bin"):
    import os

    cameras = read_cameras_binary(os.path.join(path, "cameras" + ext))
    images = read_images_binary(os.path.join(path, "images" + ext))
    points3d = read_points3d_binary(os.path.join(path, "points3D" + ext))
    return cameras, images, points3d


def read_dense_bin_array(path: str) -> np.ndarray:
    """COLMAP dense .bin arrays: '<w>&<h>&<c>&' ASCII header + float32 data."""
    with open(path, "rb") as fid:
        width, height, channels = np.genfromtxt(
            fid, delimiter="&", max_rows=1, usecols=(0, 1, 2), dtype=int)
        fid.seek(0)
        n_delim = 0
        while n_delim < 3:
            if fid.read(1) == b"&":
                n_delim += 1
        arr = np.fromfile(fid, np.float32)
    arr = arr.reshape((width, height, channels), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()


def write_cameras_binary(cameras: dict, path: str) -> None:
    """Writer (for tests / synthetic fixtures)."""
    name_to_id = {m.model_name: m.model_id for m in CAMERA_MODELS}
    with open(path, "wb") as fid:
        fid.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            fid.write(struct.pack("<iiQQ", cam.id, name_to_id[cam.model],
                                  cam.width, cam.height))
            fid.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(images: dict, path: str) -> None:
    with open(path, "wb") as fid:
        fid.write(struct.pack("<Q", len(images)))
        for im in images.values():
            fid.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                  im.camera_id))
            fid.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.point3D_ids)
            fid.write(struct.pack("<Q", n))
            for xy, pid in zip(im.xys, im.point3D_ids):
                fid.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))
