"""SCARED and Hamlyn datasets: the port of ``ucnerf_tpu.data.scared``.

Scene layout on disk:
  <scan>/images/*.jpeg        1280x1024 endoscope frames (Hamlyn: *.jpg)
  <scan>/depths/*.png         GT depth, uint16 millimetres
  <scan>/dpt/*.npz            DPT monocular prior ('pred')
  <scan>/sparse/0/*.bin       COLMAP sparse model
  <scan>/poses_bounds.npy     LLFF poses

Default 0.25 downsample -> 320x256; GT depth mm -> m.  Frames decode
through the port's JPEG decoder or ``utils/png.py`` and resize through the
numpy twins of PIL's and cv2's resizes (``data/resize.py``), so no cv2 or
PIL is needed.  The scene cache ``<scan>/_ucnerf_cache.npz`` has the JAX
package's format, key and arrays: either package loads a cache the other
wrote, and a stale key rebuilds.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from ucnerf_torch.data.base import (SceneDataset, load_colmap_sparse_depth,
                                    normalize_image)
from ucnerf_torch.data.image_io import read_depth_png, read_frame
from ucnerf_torch.data.llff import load_poses_bounds, prepare_scene_poses
from ucnerf_torch.data.resize import (cv2_linear_f32, cv2_nearest_scale,
                                      pil_bilinear_u8)


class ScaredDataset(SceneDataset):
    downsample = 0.25
    native_wh = (1280, 1024)
    img_ext = "jpeg"
    depth_scale = 1.0 / 1000.0  # mm -> m

    def __init__(self, datadir, split="train", n_views=7, downsample=None,
                 **kw):
        # --imgScale_train/test (reference opt.py:18-19, consumed as the
        # dataset's downSample at data/scared.py:164-167)
        if downsample is not None:
            self.downsample = float(downsample)
        img_wh = (int(self.native_wh[0] * self.downsample),
                  int(self.native_wh[1] * self.downsample))
        assert img_wh[0] % 32 == 0 and img_wh[1] % 32 == 0, (
            f"imgScale {self.downsample} gives {img_wh}; the cascade needs "
            "multiple-of-32 dims")
        super().__init__(datadir, split, n_views, img_wh, **kw)

    # ------------------------------------------------------------ IO helpers
    def _read_image(self, path):
        img = pil_bilinear_u8(read_frame(path), self.img_wh)
        img01 = np.asarray(img, np.float32)[..., :3] / 255.0
        return normalize_image(img01)

    def _read_gt_depth(self, path):
        # cv2.imread gives None for a missing file; an unreadable one
        # raises here
        if not os.path.exists(path):
            return np.zeros((self.img_wh[1], self.img_wh[0]), np.float32)
        d = read_depth_png(path).astype(np.float32) * self.depth_scale
        return cv2_nearest_scale(d, self.downsample)

    def _read_dpt(self, path):
        if not os.path.exists(path):
            return np.zeros((self.img_wh[1], self.img_wh[0]), np.float32)
        d = np.load(path)["pred"]
        if d.ndim == 3:
            d = d[0]
        return cv2_linear_f32(d.astype(np.float32), self.img_wh)

    # ------------------------------------------------------------ scene cache
    # Bump when the cache LAYOUT changes so old files rebuild instead of
    # misloading.  (The key below also covers parameter/source changes.)
    CACHE_FORMAT_VERSION = 2

    def _cache_key(self, scan) -> str:
        """Fingerprint of everything the cached arrays depend on, the same
        string the JAX package writes, so a cache either package wrote
        loads in the other.  Covered: format version, img_wh, downsample,
        and (size, mtime_ns) of poses_bounds.npy + every sparse/0 model
        file + the image count: a copy of a scan keeps its cache only if
        it keeps the mtimes (``cp -p``, ``rsync -a``)."""
        sdir = self._scene_dir(scan)

        def fp(path):
            st = os.stat(path)
            return [os.path.basename(path), int(st.st_size),
                    int(st.st_mtime_ns)]

        sources = []
        pb = os.path.join(sdir, "poses_bounds.npy")
        if os.path.exists(pb):
            sources.append(fp(pb))
        for p in sorted(glob.glob(os.path.join(sdir, "sparse", "0", "*"))):
            sources.append(fp(p))
        n_images = len(glob.glob(os.path.join(sdir, "images", "*")))
        return json.dumps(dict(
            version=self.CACHE_FORMAT_VERSION,
            img_wh=list(self.img_wh), downsample=self.downsample,
            n_images=n_images, sources=sources), sort_keys=True)

    # ------------------------------------------------------------ scene load
    def _load_scene(self, scan):
        sdir = self._scene_dir(scan)
        cache = os.path.join(sdir, "_ucnerf_cache.npz")
        key = self._cache_key(scan)
        if os.path.exists(cache):
            scene = self._load_cache(cache, expect_key=key)
            if scene is not None:
                return scene
            print(f"scene {scan}: stale _ucnerf_cache.npz "
                  "(resolution/sources/format changed) — rebuilding")
        scene = self._load_scene_uncached(scan)
        try:
            self._save_cache(cache, scene, key)
        except OSError:
            pass  # read-only dataset dirs are fine; just skip the cache
        return scene

    def _save_cache(self, path, scene, key: str):
        flat = {k: scene[k] for k in ("images", "depths", "dpt", "c2ws",
                                      "w2cs", "intrinsic", "near_far",
                                      "bounds")}
        for i, e in enumerate(scene["sparse"]):
            for k in ("depth_img", "weight_img", "coords", "depths",
                      "weights"):
                flat[f"sparse{i}_{k}"] = e[k]
        flat["n_sparse"] = np.asarray(len(scene["sparse"]))
        flat["cache_key"] = np.asarray(key)
        np.savez(path, **flat)

    def _load_cache(self, path, expect_key: str = None):
        data = np.load(path, allow_pickle=False)
        if expect_key is not None:
            if "cache_key" not in data.files:   # pre-keying cache file
                return None
            if str(data["cache_key"]) != expect_key:
                return None
        n = int(data["n_sparse"])
        sparse = [
            {k: data[f"sparse{i}_{k}"] for k in ("depth_img", "weight_img",
                                                 "coords", "depths",
                                                 "weights")}
            for i in range(n)]
        return dict(images=data["images"], depths=data["depths"],
                    dpt=data["dpt"], sparse=sparse, c2ws=data["c2ws"],
                    w2cs=data["w2cs"], intrinsic=data["intrinsic"],
                    near_far=data["near_far"], bounds=data["bounds"])

    def _load_scene_uncached(self, scan):
        sdir = self._scene_dir(scan)
        img_paths = sorted(glob.glob(os.path.join(sdir, "images/*")))
        pose_info = prepare_scene_poses(
            os.path.join(sdir, "poses_bounds.npy"), self.img_wh)
        _, bds_raw = load_poses_bounds(os.path.join(sdir, "poses_bounds.npy"))

        sparse = load_colmap_sparse_depth(
            sdir, self.img_wh, factor=1.0 / self.downsample, bds_raw=bds_raw)

        images, depths, dpts = [], [], []
        for p in img_paths:
            images.append(self._read_image(p))
            dpath = (p.replace("images", "depths")
                     .replace(self.img_ext, "png"))
            depths.append(self._read_gt_depth(dpath))
            dpt_path = (p.replace("images", "dpt")
                        .replace(self.img_ext, "npz"))
            dpts.append(self._read_dpt(dpt_path))

        return dict(
            images=np.stack(images), depths=np.stack(depths),
            dpt=np.stack(dpts), sparse=sparse,
            c2ws=pose_info["c2ws"], w2cs=pose_info["w2cs"],
            intrinsic=pose_info["intrinsic"], near_far=pose_info["near_far"],
            bounds=pose_info["bounds"])


class HamlynDataset(ScaredDataset):
    """Hamlyn (reference ``data/hamlyn.py:208-579``): 320x256 native images,
    no mm scaling, .jpg extension."""
    downsample = 1.0
    native_wh = (320, 256)
    img_ext = "jpg"
    depth_scale = 1.0
