"""Device-resident scene store: index-only training samples (the port of
``ucnerf_tpu.data.device_store``).

Every array of a ``SceneDataset`` sample is a gather from per-scene arrays
that never change during training, yet ``__getitem__`` assembles and ships
a whole sample (V full-size images, sparse maps, pyramids, matrices) per
step.  The store puts each scan's arrays on the device once; per step the
host builds only ``{scan_idx, view_ids [V], sparse_coords [n, 2],
sparse_mask [n]}`` and ``gather_batch`` assembles the batch on the device
by tensor indexing.  ``gather_batch`` reproduces ``__getitem__`` bit for
bit for every field the train step reads (tested), so the objective is
unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ucnerf_torch.data.base import (SceneDataset, build_affine_mats,
                                    make_stage_pyramid)


def build_store(ds: SceneDataset, device) -> Dict:
    """Every scan's per-view arrays, stacked and put on ``device``.

    Scans with fewer views than the widest are zero-padded on the view
    axis (metas only index valid views).  Weight images are per-view
    min-max normalized and the pyramids built exactly as in
    ``__getitem__``, so gathers are bit-identical."""
    W, H = ds.img_wh
    n_max = max(len(ds.scene[s]["c2ws"]) for s in ds.scans)
    S = len(ds.scans)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    images = zeros(S, n_max, H, W, 3)
    sparse_depth = zeros(S, n_max, H, W)
    sparse_weight = zeros(S, n_max, H, W)
    dpt = zeros(S, n_max, H, W)
    c2ws = zeros(S, n_max, 4, 4)
    w2cs = zeros(S, n_max, 4, 4)
    affine = zeros(S, n_max, 3, 4, 4)
    affine_inv = zeros(S, n_max, 3, 4, 4)
    intrinsics = zeros(S, 3, 3)
    near_fars = zeros(S, 2)
    pyr = {k: zeros(S, n_max, H // f, W // f)
           for k, f in (("stage1", 4), ("stage2", 2), ("stage3", 1))}
    wpyr = {k: np.zeros_like(v) for k, v in pyr.items()}

    for si, scan in enumerate(ds.scans):
        sc = ds.scene[scan]
        n = len(sc["c2ws"])
        images[si, :n] = sc["images"].astype(np.float32)
        c2ws[si, :n] = sc["c2ws"]
        w2cs[si, :n] = sc["w2cs"]
        intrinsics[si] = sc["intrinsic"]
        near_fars[si] = sc["near_far"]
        if sc.get("dpt") is not None:
            dpt[si, :n] = sc["dpt"]
        for v in range(n):
            affine[si, v], affine_inv[si, v] = build_affine_mats(
                sc["intrinsic"], sc["w2cs"][v])
            dg = sc["sparse"][v]
            sparse_depth[si, v] = dg["depth_img"]
            w_img = dg["weight_img"].copy()
            wmin, wmax = w_img.min(), w_img.max()
            if wmax > wmin:
                w_img = (w_img - wmin) / (wmax - wmin)
            sparse_weight[si, v] = w_img.astype(np.float32)
            p = make_stage_pyramid(dg["depth_img"])
            wp = make_stage_pyramid(sparse_weight[si, v])
            for k in pyr:
                pyr[k][si, v] = p[k]
                wpyr[k][si, v] = wp[k]

    def put(tree):
        if isinstance(tree, dict):
            return {k: put(v) for k, v in tree.items()}
        return torch.as_tensor(tree, device=device)

    return put(dict(
        images=images, sparse_depth=sparse_depth,
        sparse_weight=sparse_weight, dpt=dpt, c2ws=c2ws, w2cs=w2cs,
        affine=affine, affine_inv=affine_inv, intrinsics=intrinsics,
        near_fars=near_fars, sparse_depth_ms=pyr, weight_ms=wpyr))


def sample_indices(ds: SceneDataset, idx: int) -> Dict[str, np.ndarray]:
    """The per-sample payload: indices and the host-side sparse-ray subset
    draw (the same stateless (seed, epoch, idx) draw as ``__getitem__``, so
    the training stream equals the host-loaded one)."""
    scan, ref, srcs = ds.metas[idx]
    coords = ds.scene[scan]["sparse"][ref]["coords"]
    item_rng = np.random.default_rng(
        np.random.SeedSequence([ds.seed, ds._epoch, idx]))
    sel = coords[item_rng.permutation(len(coords))[:ds.n_depth_rays]]
    pad_coords = np.zeros((ds.n_depth_rays, 2), np.int32)
    pad_coords[:len(sel)] = sel
    mask = np.zeros((ds.n_depth_rays,), np.float32)
    mask[:len(sel)] = 1.0
    return dict(scan_idx=np.int32(ds.scans.index(scan)),
                view_ids=np.asarray([ref] + list(srcs), np.int32),
                sparse_coords=pad_coords, sparse_mask=mask)


def gather_batch(store: Dict, inds: Dict) -> Dict:
    """The train step's batch from the store and a ``sample_indices``
    payload on the store's device: the twin of ``__getitem__`` less the
    eval-only GT depth (``depths_h`` is served as zeros, as the train-split
    datasets without GT depth serve it)."""
    s = inds["scan_idx"].long()
    v = inds["view_ids"].long()
    ref = v[0]
    V = v.shape[0]

    def per_view(a):
        return a[s][v]

    def at_ref(a):
        return a[s][ref]

    return dict(
        images=per_view(store["images"]),
        c2ws=per_view(store["c2ws"]), w2cs=per_view(store["w2cs"]),
        intrinsics=store["intrinsics"][s].expand(V, 3, 3).contiguous(),
        affine_mat=per_view(store["affine"]),
        affine_mat_inv=per_view(store["affine_inv"]),
        near_fars=store["near_fars"][s].expand(V, 2).contiguous(),
        depths_h=torch.zeros_like(at_ref(store["dpt"])),
        dpt=at_ref(store["dpt"]),
        sparse_depths=at_ref(store["sparse_depth"]),
        sparse_weights=at_ref(store["sparse_weight"]),
        sparse_coords=inds["sparse_coords"],
        sparse_mask=inds["sparse_mask"],
        view_ids=inds["view_ids"], scan_idx=inds["scan_idx"],
        sparse_depth_ms={k: at_ref(a)
                         for k, a in store["sparse_depth_ms"].items()},
        weight_ms={k: at_ref(a) for k, a in store["weight_ms"].items()})


def store_nbytes(store: Dict) -> int:
    """Bytes the store holds on its device."""
    return sum(store_nbytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in store.values())
