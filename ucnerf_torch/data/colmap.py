"""COLMAP sparse-model binary/text I/O: a copy of ``ucnerf_tpu.data.colmap``.

Readers and writers for the binary (``cameras.bin``, ``images.bin``,
``points3D.bin``) and text model formats, ``read_model`` /
``write_model`` with format detection, and the quaternion helpers.  Pure
numpy/struct.  The writers let ``chip_smoke.py`` fabricate a scene on a
machine without the JAX package.
"""

from __future__ import annotations

import collections
import os
import struct
from typing import Dict

import numpy as np

Camera = collections.namedtuple("Camera",
                                ["id", "model", "width", "height", "params"])
Image = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

# model_id -> (name, num_params) per the COLMAP camera model table
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


def qvec2rotmat(qvec):
    """Quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R):
    """Rotation matrix -> quaternion (w, x, y, z)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1],
         R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0]) if q[0] != 0 else q


def _read(fh, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def read_cameras_binary(path) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fh, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fh, "<" + "d" * n_params))
            cams[cam_id] = Camera(cam_id, name, width, height, params)
    return cams


def read_images_binary(path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            img_id = _read(fh, "<i")[0]
            qvec = np.array(_read(fh, "<dddd"))
            tvec = np.array(_read(fh, "<ddd"))
            cam_id = _read(fh, "<i")[0]
            name = b""
            while True:
                c = fh.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(fh, "<Q")
            raw = np.frombuffer(fh.read(24 * n_pts),
                                dtype=[("x", "<f8"), ("y", "<f8"),
                                       ("id", "<i8")])
            xys = np.stack([raw["x"], raw["y"]], axis=-1)
            images[img_id] = Image(img_id, qvec, tvec, cam_id,
                                   name.decode("utf-8"), xys,
                                   raw["id"].copy())
    return images


def read_points3d_binary(path) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            pt_id = _read(fh, "<q")[0]
            xyz = np.array(_read(fh, "<ddd"))
            rgb = np.array(_read(fh, "<BBB"))
            error = _read(fh, "<d")[0]
            (track_len,) = _read(fh, "<Q")
            raw = np.frombuffer(fh.read(8 * track_len),
                                dtype=[("img", "<i4"), ("p2d", "<i4")])
            points[pt_id] = Point3D(pt_id, xyz, rgb, error,
                                    raw["img"].copy(), raw["p2d"].copy())
    return points


def write_cameras_binary(cams: Dict[int, Camera], path):
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid, n_params = CAMERA_MODEL_IDS[cam.model]
            fh.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            fh.write(struct.pack("<" + "d" * n_params, *cam.params))


def write_images_binary(images: Dict[int, Image], path):
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(images)))
        for im in images.values():
            fh.write(struct.pack("<i", im.id))
            fh.write(struct.pack("<dddd", *im.qvec))
            fh.write(struct.pack("<ddd", *im.tvec))
            fh.write(struct.pack("<i", im.camera_id))
            fh.write(im.name.encode("utf-8") + b"\x00")
            fh.write(struct.pack("<Q", len(im.xys)))
            for xy, pid in zip(im.xys, im.point3D_ids):
                fh.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def write_points3d_binary(points: Dict[int, Point3D], path):
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            fh.write(struct.pack("<q", int(pt.id)))
            fh.write(struct.pack("<ddd", *pt.xyz))
            fh.write(struct.pack("<BBB", *np.asarray(pt.rgb, np.uint8)))
            fh.write(struct.pack("<d", float(pt.error)))
            fh.write(struct.pack("<Q", len(pt.image_ids)))
            for img_id, p2d in zip(pt.image_ids, pt.point2D_idxs):
                fh.write(struct.pack("<ii", int(img_id), int(p2d)))


# ----------------------------------------------------------- text format
# COLMAP's .txt models: '#' comment lines, whitespace-separated records.
# cameras.txt   CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]
# images.txt    two lines/image: ID QW QX QY QZ TX TY TZ CAM_ID NAME
#                                then X Y POINT3D_ID triplets (may be empty)
# points3D.txt  ID X Y Z R G B ERROR (IMAGE_ID POINT2D_IDX)...

def _text_records(path):
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path) -> Dict[int, Camera]:
    cams = {}
    for line in _text_records(path):
        el = line.split()
        cam_id = int(el[0])
        cams[cam_id] = Camera(cam_id, el[1], int(el[2]), int(el[3]),
                              np.array([float(p) for p in el[4:]]))
    return cams


def read_images_text(path) -> Dict[int, Image]:
    images = {}
    header = None
    with open(path, "r") as fh:
        lines = [ln.strip() for ln in fh]
    for line in lines:
        if header is None:
            if not line or line.startswith("#"):
                continue
            # split with maxsplit so image names containing spaces survive
            el = line.split(None, 9)
            header = (int(el[0]), np.array([float(q) for q in el[1:5]]),
                      np.array([float(t) for t in el[5:8]]), int(el[8]),
                      el[9])
            continue
        # the points2D line immediately follows and may be empty
        el = line.split()
        xys = np.array([float(v) for v in el], np.float64).reshape(-1, 3)
        img_id, qvec, tvec, cam_id, name = header
        images[img_id] = Image(img_id, qvec, tvec, cam_id, name,
                               xys[:, :2].copy() if len(xys) else
                               np.zeros((0, 2)),
                               xys[:, 2].astype(np.int64) if len(xys) else
                               np.zeros((0,), np.int64))
        header = None
    return images


def read_points3d_text(path) -> Dict[int, Point3D]:
    points = {}
    for line in _text_records(path):
        el = line.split()
        pt_id = int(el[0])
        xyz = np.array([float(v) for v in el[1:4]])
        rgb = np.array([int(v) for v in el[4:7]])
        error = float(el[7])
        track = np.array([int(v) for v in el[8:]], np.int64).reshape(-1, 2)
        points[pt_id] = Point3D(pt_id, xyz, rgb, error,
                                track[:, 0].astype(np.int32),
                                track[:, 1].astype(np.int32))
    return points


def write_cameras_text(cams: Dict[int, Camera], path):
    with open(path, "w") as fh:
        fh.write("# Camera list with one line of data per camera:\n"
                 "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                 f"# Number of cameras: {len(cams)}\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            fh.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                     f"{params}\n")


def write_images_text(images: Dict[int, Image], path):
    with open(path, "w") as fh:
        fh.write("# Image list with two lines of data per image:\n"
                 "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                 "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                 f"# Number of images: {len(images)}\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            fh.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(f"{repr(float(x))} {repr(float(y))} {int(pid)}"
                           for (x, y), pid in zip(im.xys, im.point3D_ids))
            fh.write(pts + "\n")


def write_points3d_text(points: Dict[int, Point3D], path):
    with open(path, "w") as fh:
        fh.write("# 3D point list with one line of data per point:\n"
                 "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                 "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                 f"# Number of points: {len(points)}\n")
        for pt in points.values():
            xyz = " ".join(repr(float(v)) for v in pt.xyz)
            rgb = " ".join(str(int(v)) for v in pt.rgb)
            track = " ".join(f"{int(i)} {int(j)}" for i, j in
                             zip(pt.image_ids, pt.point2D_idxs))
            fh.write(f"{int(pt.id)} {xyz} {rgb} {repr(float(pt.error))} "
                     f"{track}\n".rstrip() + "\n")


def detect_model_format(sparse_dir) -> str:
    """'.bin' or '.txt', preferring binary when both exist (like COLMAP)."""
    for ext in (".bin", ".txt"):
        if all(os.path.exists(os.path.join(sparse_dir, f + ext))
               for f in ("cameras", "images", "points3D")):
            return ext
    raise FileNotFoundError(
        f"no complete COLMAP model (.bin or .txt) in {sparse_dir}")


def read_model(sparse_dir, ext: str = None):
    """Read (cameras, images, points3D) from a ``sparse/0``-style directory.

    ``ext`` is '.bin' or '.txt'; auto-detected when None."""
    if ext is None:
        ext = detect_model_format(sparse_dir)
    readers = {
        ".bin": (read_cameras_binary, read_images_binary,
                 read_points3d_binary),
        ".txt": (read_cameras_text, read_images_text, read_points3d_text),
    }[ext]
    names = ("cameras", "images", "points3D")
    return tuple(r(os.path.join(sparse_dir, n + ext))
                 for r, n in zip(readers, names))


def write_model(cams, images, points, sparse_dir, ext: str = ".bin"):
    writers = {
        ".bin": (write_cameras_binary, write_images_binary,
                 write_points3d_binary),
        ".txt": (write_cameras_text, write_images_text, write_points3d_text),
    }[ext]
    os.makedirs(sparse_dir, exist_ok=True)
    for w, n, obj in zip(writers, ("cameras", "images", "points3D"),
                         (cams, images, points)):
        w(obj, os.path.join(sparse_dir, n + ext))
