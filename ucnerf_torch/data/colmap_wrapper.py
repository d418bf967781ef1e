"""Runs the external COLMAP binary: the port of
``ucnerf_tpu.data.colmap_wrapper``.

Mirrors the reference's ``preprocess/colmap/colmap_wrapper.py:5-59``:
feature_extractor -> exhaustive/sequential matcher -> mapper, producing
``sparse/0``.  The COLMAP binary is an external tool exactly as in the
reference; when it is absent this module raises a clear error (the rest
of the pipeline only needs the ``sparse/0/*.bin`` + ``poses_bounds.npy``
artifacts, which can be produced on any machine and copied in).
"""

from __future__ import annotations

import os
import shutil
import subprocess


class ColmapNotFound(RuntimeError):
    pass


def _colmap_bin():
    path = os.environ.get("COLMAP_BIN") or shutil.which("colmap")
    if not path:
        raise ColmapNotFound(
            "COLMAP binary not found; install colmap or set COLMAP_BIN. "
            "Alternatively copy precomputed sparse/0 + poses_bounds.npy "
            "into the scene directory.")
    return path


def run_colmap(scene_dir: str, match_type: str = "exhaustive_matcher",
               camera_model: str = "OPENCV", single_camera: bool = True,
               log_name: str = "colmap_output.txt"):
    """Run the 3-stage COLMAP SfM pipeline on <scene_dir>/images."""
    colmap = _colmap_bin()
    db = os.path.join(scene_dir, "database.db")
    sparse = os.path.join(scene_dir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    logfile = open(os.path.join(scene_dir, log_name), "w")

    def run(args):
        print("colmap", " ".join(args))
        subprocess.check_call([colmap] + args, stdout=logfile,
                              stderr=subprocess.STDOUT)

    run(["feature_extractor", "--database_path", db,
         "--image_path", os.path.join(scene_dir, "images"),
         "--ImageReader.single_camera", "1" if single_camera else "0",
         "--ImageReader.camera_model", camera_model])
    run([match_type, "--database_path", db])
    run(["mapper", "--database_path", db,
         "--image_path", os.path.join(scene_dir, "images"),
         "--output_path", sparse])
    logfile.close()
    return os.path.join(sparse, "0")


def imgs2poses(scene_dir: str, match_type: str = "exhaustive_matcher"):
    """Full preprocessing: COLMAP SfM (if needed) + poses_bounds.npy
    (reference ``preprocess/colmap/imgs2poses.py:1-18`` +
    ``pose_utils.gen_poses``)."""
    from ucnerf_torch.data.llff import gen_poses
    sparse0 = os.path.join(scene_dir, "sparse", "0")
    if not os.path.exists(os.path.join(sparse0, "images.bin")):
        run_colmap(scene_dir, match_type)
    return gen_poses(scene_dir)
