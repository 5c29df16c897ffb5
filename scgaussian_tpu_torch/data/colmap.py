"""COLMAP sparse-reconstruction parsers (binary + text).

A copy of the JAX package's `data/colmap.py` (numpy only), whose native
points3D walker is the port's own build (`scgaussian_tpu_torch.native`).
Same file-format coverage as the reference's `scene/colmap_loader.py:72-327`
(cameras.bin/txt, images.bin/txt, points3D.bin/txt, incl. the point_id ->
row map of `read_points3D_binary_pointid:156-187` used for per-view near/far
computation), reimplemented with buffer-offset parsing (struct.unpack_from
over one read) instead of per-record file reads.
"""

from __future__ import annotations

import collections
import struct
from typing import Dict

import numpy as np

CameraModel = collections.namedtuple("CameraModel", ["model_id", "model_name", "num_params"])
ColmapCamera = collections.namedtuple("ColmapCamera", ["id", "model", "width", "height", "params"])
ColmapImage = collections.namedtuple(
    "ColmapImage", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)

CAMERA_MODELS = {
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix
    (`scene/colmap_loader.py:43-53`)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """`scene/colmap_loader.py:55-66`."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def read_intrinsics_binary(path: str) -> Dict[int, ColmapCamera]:
    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    (num_cameras,) = struct.unpack_from("<Q", buf, off)
    off += 8
    cameras = {}
    for _ in range(num_cameras):
        cam_id, model_id, width, height = struct.unpack_from("<iiQQ", buf, off)
        off += 24
        n = CAMERA_MODEL_IDS[model_id].num_params
        params = np.array(struct.unpack_from(f"<{n}d", buf, off))
        off += 8 * n
        cameras[cam_id] = ColmapCamera(
            cam_id, CAMERA_MODEL_IDS[model_id].model_name, width, height, params
        )
    return cameras


def read_extrinsics_binary(path: str) -> Dict[int, ColmapImage]:
    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    (num_images,) = struct.unpack_from("<Q", buf, off)
    off += 8
    images = {}
    for _ in range(num_images):
        vals = struct.unpack_from("<idddddddi", buf, off)
        off += 64
        image_id = vals[0]
        qvec = np.array(vals[1:5])
        tvec = np.array(vals[5:8])
        camera_id = vals[8]
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode("utf-8")
        off = end + 1
        (num_pts,) = struct.unpack_from("<Q", buf, off)
        off += 8
        arr = np.frombuffer(buf, dtype=np.dtype("<f8, <f8, <i8"), count=num_pts, offset=off)
        off += 24 * num_pts
        xys = np.column_stack([arr["f0"], arr["f1"]])
        point3D_ids = arr["f2"].astype(np.int64)
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys, point3D_ids)
    return images


def read_points3D_binary(path: str):
    xyzs, rgbs, errors, _ = read_points3D_binary_pointid(path)
    return xyzs, rgbs, errors


def read_points3D_binary_pointid(path: str):
    """Returns (xyz [N,3], rgb [N,3], error [N,1], point_id -> row dict).

    Uses the native C++ walker (native/colmap_fast.cpp), one pass over the
    buffer, when it builds, with this pure-Python per-record loop as the
    fallback."""
    with open(path, "rb") as f:
        buf = f.read()

    native = _points3d_native(buf)
    if native is not None:
        return native

    off = 0
    (num_points,) = struct.unpack_from("<Q", buf, off)
    off += 8
    xyzs = np.empty((num_points, 3))
    rgbs = np.empty((num_points, 3))
    errors = np.empty((num_points, 1))
    point_ids: Dict[int, int] = {}
    for i in range(num_points):
        vals = struct.unpack_from("<QdddBBBd", buf, off)
        off += 43
        point_ids[vals[0]] = i
        xyzs[i] = vals[1:4]
        rgbs[i] = vals[4:7]
        errors[i] = vals[7]
        (track_len,) = struct.unpack_from("<Q", buf, off)
        off += 8 + 8 * track_len
    return xyzs, rgbs, errors, point_ids


def _points3d_native(buf: bytes):
    """ctypes bridge to native/colmap_fast.cpp; None if unavailable."""
    import ctypes

    from scgaussian_tpu_torch.native import load_library

    lib = load_library("colmap_fast")
    if lib is None:
        return None
    fn = lib.parse_points3d
    fn.restype = ctypes.c_longlong
    fn.argtypes = [
        ctypes.c_char_p,
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_ulonglong),
    ]
    n = fn(buf, len(buf), 0, None, None, None, None)
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    ids = np.empty((n,), np.uint64)
    n2 = fn(
        buf,
        len(buf),
        n,
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_ulonglong)),
    )
    if n2 != n:
        return None
    point_ids = {int(pid): i for i, pid in enumerate(ids)}
    return xyz, rgb.astype(np.float64), err[:, None], point_ids


def read_intrinsics_text(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cam_id = int(elems[0])
            model = elems[1]
            cameras[cam_id] = ColmapCamera(
                cam_id,
                model,
                int(elems[2]),
                int(elems[3]),
                np.array(list(map(float, elems[4:]))),
            )
    return cameras


def read_extrinsics_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.strip().startswith("#")]
    for i in range(0, len(lines), 2):
        elems = lines[i].split()
        image_id = int(elems[0])
        qvec = np.array(list(map(float, elems[1:5])))
        tvec = np.array(list(map(float, elems[5:8])))
        camera_id = int(elems[8])
        name = elems[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.column_stack(
            [list(map(float, pts[0::3])), list(map(float, pts[1::3]))]
        ) if pts else np.zeros((0, 2))
        point3D_ids = np.array(list(map(int, pts[2::3])), dtype=np.int64)
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys, point3D_ids)
    return images


def read_points3D_text(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            rows.append(
                (list(map(float, elems[1:4])), list(map(int, elems[4:7])), float(elems[7]))
            )
    xyzs = np.array([r[0] for r in rows])
    rgbs = np.array([r[1] for r in rows])
    errors = np.array([[r[2]] for r in rows])
    return xyzs, rgbs, errors


# ----- writers (for test fixtures and convert.py-style tooling) -----

def write_intrinsics_binary(path: str, cameras: Dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = CAMERA_MODEL_NAMES[cam.model].model_id
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_extrinsics_binary(path: str, images: Dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.point3D_ids)
            f.write(struct.pack("<Q", n))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def write_points3D_binary(path: str, xyz: np.ndarray, rgb: np.ndarray, error: np.ndarray,
                          ids: np.ndarray | None = None) -> None:
    n = xyz.shape[0]
    ids = np.arange(1, n + 1) if ids is None else ids
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(
                struct.pack(
                    "<QdddBBBd",
                    int(ids[i]),
                    *xyz[i],
                    *rgb[i].astype(np.uint8),
                    float(error[i]),
                )
            )
            f.write(struct.pack("<Q", 0))  # empty track
