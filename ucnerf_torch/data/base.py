"""Shared scene-dataset machinery (numpy only).

A copy of the sample contract of ``ucnerf_tpu.data.base``, channel-last
and fixed-shape:

  images            (V, H, W, 3) float32  ImageNet-normalized, view 0 = target
  w2cs, c2ws        (V, 4, 4)
  intrinsics        (V, 3, 3)
  affine_mat(_inv)  (V, 3, 4, 4)   per-stage K@w2c at scales /4, /2, /1
  near_fars         (V, 2)
  depths_h          (H, W)         GT depth (zeros if absent)
  dpt               (H, W)         monocular depth prior
  sparse_depths     (H, W)         splatted sparse point depths
  sparse_weights    (H, W)         splatted, [0,1]-normalized weights
  sparse_depth_ms   {stage1/2/3}   nearest-resized pyramids (depth & weight)
  weight_ms
  sparse_coords     (n_depth_rays, 2) int32 (y, x), zero-padded
  sparse_mask       (n_depth_rays,) float32 slot validity
  view_ids          (V,) int32
  scan_idx          () int32

The pyramids follow cv2's ``INTER_NEAREST`` index law
(``make_stage_pyramid``), as the JAX package builds them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ucnerf_torch.data import colmap
from ucnerf_torch.data.llff import get_nearest_pose_ids
from ucnerf_torch.data.resize import cv2_nearest_size

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(img01):
    return (img01 - IMAGENET_MEAN) / IMAGENET_STD


def unnormalize_image(img):
    return img * IMAGENET_STD + IMAGENET_MEAN


def load_colmap_sparse_depth(scene_dir, img_wh, factor, bds_raw,
                             bd_factor=0.75):
    """Project COLMAP 3D points into every image -> per-image sparse depth
    (``ucnerf_tpu.data.base.load_colmap_sparse_depth``).

    depth = c2w_z . (pt - cam_center), scaled by 1/(bds.min()*bd_factor);
    points outside that image's raw bounds are dropped; weight =
    2*exp(-(err/err_mean)^2); splat at (y, x) = point2D[::-1]/factor
    (integer truncation).  Entries are returned sorted by image name, and
    ``bds_raw`` rows are taken in that order (LLFF's save order).
    """
    images = colmap.read_images_binary(
        os.path.join(scene_dir, "sparse", "0", "images.bin"))
    points = colmap.read_points3d_binary(
        os.path.join(scene_dir, "sparse", "0", "points3D.bin"))
    errs = np.array([p.error for p in points.values()])
    err_mean = errs.mean()
    sc = 1.0 / (bds_raw.min() * bd_factor)

    w_img, h_img = img_wh
    entries = []
    order = sorted(images.keys(), key=lambda i: images[i].name)
    for k, img_id in enumerate(order):
        im = images[img_id]
        R = colmap.qvec2rotmat(im.qvec)
        t = im.tvec
        c2w_R = R.T
        center = -R.T @ t
        depth_img = np.zeros((h_img, w_img), np.float32)
        weight_img = np.zeros((h_img, w_img), np.float32)
        coords, depths, weights = [], [], []
        lo, hi = bds_raw[k] * sc if bds_raw.ndim == 2 else bds_raw * sc
        for xy, pid in zip(im.xys, im.point3D_ids):
            if pid == -1 or pid not in points:
                continue
            pt = points[pid]
            depth = float(c2w_R[:, 2] @ (pt.xyz - center)) * sc
            if depth < lo or depth > hi:
                continue
            weight = 2.0 * np.exp(-(pt.error / err_mean) ** 2)
            h = int(xy[1] / factor)
            w = int(xy[0] / factor)
            if w >= w_img or h >= h_img:
                continue
            depth_img[h, w] = depth
            weight_img[h, w] = weight
            coords.append((h, w))
            depths.append(depth)
            weights.append(weight)
        entries.append(dict(
            name=im.name,
            depth_img=depth_img, weight_img=weight_img,
            coords=np.array(coords, np.int32).reshape(-1, 2),
            depths=np.array(depths, np.float32),
            weights=np.array(weights, np.float32)))
    entries.sort(key=lambda e: e["name"])
    return entries


def make_stage_pyramid(img):
    """/4, /2, /1 nearest pyramid at (w // f, h // f), as
    ``cv2.resize(img, (w // f, h // f), INTER_NEAREST)``: ``src =
    floor(dst * in / out)``, every f-th pixel where the size divides by f."""
    h, w = img.shape
    return {"stage1": cv2_nearest_size(img, (w // 4, h // 4)),
            "stage2": cv2_nearest_size(img, (w // 2, h // 2)),
            "stage3": img}


def build_affine_mats(intrinsic, w2c):
    """Per-stage K@w2c 4x4s at scales /4, /2, /1."""
    affs, affs_inv = [], []
    for s in range(3):
        K = intrinsic.copy()
        K[:2] = intrinsic[:2] / (2 ** (2 - s))
        m = np.eye(4, dtype=np.float32)
        m[:3, :4] = K @ w2c[:3, :4]
        affs.append(m)
        affs_inv.append(np.linalg.inv(m))
    return np.stack(affs), np.stack(affs_inv)


class SceneDataset:
    """Base class: holds per-scene arrays, builds (scan, ref, srcs) metas and
    assembles fixed-shape samples.  Subclasses implement scene loading."""

    def __init__(self, datadir: str, split: str, n_views: int, img_wh,
                 n_depth_rays: int = 1024, max_train_samples: int = 200,
                 sample_rate: int = 2, finetune_scan: Optional[str] = None,
                 seed: int = 0):
        self.datadir = datadir
        self.split = split
        self.nviews = n_views
        self.img_wh = tuple(img_wh)
        self.n_depth_rays = n_depth_rays
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._epoch = 0
        self.scans = self._discover_scans()
        if finetune_scan is not None:
            self.scans = [finetune_scan]
        self.scene: Dict[str, dict] = {}
        for scan in self.scans:
            self.scene[scan] = self._load_scene(scan)
        self._build_metas(max_train_samples, sample_rate)

    def _discover_scans(self) -> List[str]:
        return sorted(d for d in os.listdir(self.datadir)
                      if os.path.isdir(os.path.join(self.datadir, d)))

    def _scene_dir(self, scan):
        return os.path.join(self.datadir, scan)

    def _load_scene(self, scan) -> dict:
        raise NotImplementedError

    def _build_metas(self, max_train_samples, sample_rate):
        self.metas = []
        for scan in self.scans:
            sc = self.scene[scan]
            n = len(sc["c2ws"])
            ids = np.arange(n)
            train_idx = ids[sample_rate // 2::sample_rate]
            test_idx = np.array([i for i in ids if i not in train_idx])
            sc["train_index"], sc["test_index"] = train_idx, test_idx
            if self.split == "train" and len(train_idx) < self.nviews:
                raise ValueError(
                    f"scene {scan}: {len(train_idx)} train views < "
                    f"view_num={self.nviews}; need more images")
            if self.split == "train":
                for _ in range(max_train_samples):
                    sel = self.rng.permutation(train_idx)
                    self.metas.append((scan, int(sel[0]),
                                       sel[1:self.nviews].tolist()))
            else:
                for k in range(len(test_idx)):
                    ref = int(test_idx[k])
                    near = get_nearest_pose_ids(sc["c2ws"][ref],
                                                sc["c2ws"][train_idx],
                                                self.nviews - 1)
                    self.metas.append((scan, ref,
                                       train_idx[near].tolist()))

    def __len__(self):
        return len(self.metas)

    def set_epoch(self, epoch: int):
        """Pin the per-sample randomness to (seed, epoch, idx)."""
        self._epoch = int(epoch)

    def __getitem__(self, idx):
        scan, ref, srcs = self.metas[idx]
        sc = self.scene[scan]
        view_ids = [ref] + list(srcs)
        W, H = self.img_wh

        imgs = np.stack([sc["images"][v] for v in view_ids])
        c2ws = np.stack([sc["c2ws"][v] for v in view_ids])
        w2cs = np.stack([sc["w2cs"][v] for v in view_ids])
        intr = np.broadcast_to(sc["intrinsic"], (len(view_ids), 3, 3)).copy()
        near_fars = np.broadcast_to(sc["near_far"],
                                    (len(view_ids), 2)).copy()
        affs, affs_inv = [], []
        for v in view_ids:
            a, ai = build_affine_mats(sc["intrinsic"], sc["w2cs"][v])
            affs.append(a)
            affs_inv.append(ai)

        dg = sc["sparse"][ref]
        weight_img = dg["weight_img"].copy()
        wmin, wmax = weight_img.min(), weight_img.max()
        if wmax > wmin:
            weight_img = (weight_img - wmin) / (wmax - wmin)

        coords = dg["coords"]
        item_rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self._epoch, idx]))
        perm = item_rng.permutation(len(coords))[:self.n_depth_rays]
        sel = coords[perm]
        n_valid = len(sel)
        pad_coords = np.zeros((self.n_depth_rays, 2), np.int32)
        pad_coords[:n_valid] = sel
        mask = np.zeros((self.n_depth_rays,), np.float32)
        mask[:n_valid] = 1.0

        sample = dict(
            images=imgs.astype(np.float32),
            c2ws=c2ws.astype(np.float32), w2cs=w2cs.astype(np.float32),
            intrinsics=intr.astype(np.float32),
            affine_mat=np.stack(affs), affine_mat_inv=np.stack(affs_inv),
            near_fars=near_fars.astype(np.float32),
            depths_h=sc["depths"][ref] if sc.get("depths") is not None
            else np.zeros((H, W), np.float32),
            dpt=sc["dpt"][ref] if sc.get("dpt") is not None
            else np.zeros((H, W), np.float32),
            sparse_depths=dg["depth_img"],
            sparse_weights=weight_img.astype(np.float32),
            sparse_coords=pad_coords, sparse_mask=mask,
            view_ids=np.array(view_ids, np.int32),
            scan_idx=np.int32(self.scans.index(scan)),
        )
        sample["sparse_depth_ms"] = make_stage_pyramid(sample["sparse_depths"])
        sample["weight_ms"] = make_stage_pyramid(sample["sparse_weights"])
        return sample
