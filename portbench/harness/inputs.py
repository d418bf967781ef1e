"""The benchmark's inputs, made from ``--seed`` by its own code.

Both sides get the same inputs: the program through its own entry points,
the reference (``portbench/reference``) directly.

- ``make_scene``: the procedural scene of the port's ``data/synthetic.py``
  (a textured tilted plane seen by a ring of nearby cameras, analytic
  depth as the sparse points and the DPT prior), with its geometry,
  texture and sparse points drawn from the seed.  Every seed gives the
  same sizes.
- ``make_weights``: every weight of the cascade and the MLP under the
  port's state-dict names, drawn on the device by one generator in two
  calls (one normal, one uniform), with the port's init laws.
- ``train_draws``: one train step's ray draws (Gumbel noise, patch shifts,
  uniform pixels, depth jitter), drawn on the device.
- ``make_sample``, ``train_metas``, ``serve_views``: the scene-dataset
  sample contract of the port's ``data/base.py``, a frozen copy, which the
  reference uses to rebuild what the program's data path gathers.
- ``trajectory``: the served target poses, each between two of the scene's
  cameras.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def seed_int(seed: int, *keys: int) -> int:
    """A 63-bit integer seed for one stream of the run's randomness."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, *keys])
    return int(ss.generate_state(2, np.uint32).astype(np.uint64)
               .dot([1, 2 ** 32]) % 2 ** 63)


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, *keys]))


# ------------------------------------------------------------------- scene

def make_scene(seed: int, img_wh, n_images: int, n_sparse: int,
               focal_frac: float = 0.1875) -> Dict:
    """The scene's arrays: images (ImageNet-normalized) [n, H, W, 3],
    depths, dpt [n, H, W], per-image sparse points, c2ws, w2cs [n, 4, 4],
    intrinsic [3, 3], near_far [2].  ``focal_frac`` * W is the focal
    length (60 px at the synthetic scene's 320 px)."""
    W, H = img_wh
    rng = _rng(seed, 1)
    focal = focal_frac * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 np.float32)
    a = rng.uniform(0.05, 0.25)
    b = -rng.uniform(0.03, 0.15)
    z0 = rng.uniform(1.3, 1.7)
    freq = rng.uniform(0.8, 1.25, 6)
    phase = rng.uniform(0.0, 2 * np.pi, 6)

    def texture(x, y):
        r = (0.5 + 0.25 * np.sin(2.1 * freq[0] * x + phase[0])
             + 0.2 * np.cos(1.3 * freq[1] * y + phase[1]))
        g = (0.5 + 0.25 * np.sin(1.7 * freq[2] * x + 1.1 * y + phase[2])
             + 0.15 * np.cos(2.9 * freq[3] * y + phase[3]))
        bl = (0.5 + 0.3 * np.cos(1.1 * freq[4] * x - 0.7 * y + phase[4])
              + 0.1 * np.sin(3.1 * freq[5] * y + phase[5]))
        return np.clip(np.stack([r, g, bl], axis=-1), 0.05, 0.95)

    ring = rng.uniform(0.8, 1.2)
    c2ws = []
    for i in range(n_images):
        t = ring * np.array([0.12 * np.sin(2 * np.pi * i / n_images),
                             0.08 * np.cos(2 * np.pi * i / n_images),
                             0.04 * np.sin(4 * np.pi * i / n_images)])
        yaw, pitch = -0.15 * t[0], 0.15 * t[1]
        Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]])
        Rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)],
                       [0, np.sin(pitch), np.cos(pitch)]])
        m = np.eye(4)
        m[:3, :3] = Ry @ Rx
        m[:3, 3] = t
        c2ws.append(m.astype(np.float32))
    c2ws = np.stack(c2ws)
    w2cs = np.linalg.inv(c2ws).astype(np.float32)

    us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    d_cam = np.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1],
                      np.ones_like(us)], axis=-1)
    images, depths, sparse = [], [], []
    for i in range(n_images):
        R = c2ws[i, :3, :3].astype(np.float64)
        o = c2ws[i, :3, 3].astype(np.float64)
        d_w = d_cam @ R.T
        denom = d_w[..., 2] - a * d_w[..., 0] - b * d_w[..., 1]
        t = (z0 + a * o[0] + b * o[1] - o[2]) / denom
        p = o + t[..., None] * d_w
        img = texture(p[..., 0] * 6.0, p[..., 1] * 6.0).astype(np.float32)
        images.append((img - IMAGENET_MEAN) / IMAGENET_STD)
        depth = t.astype(np.float32)
        depths.append(depth)
        ys = rng.integers(0, H, n_sparse)
        xs = rng.integers(0, W, n_sparse)
        depth_img = np.zeros((H, W), np.float32)
        weight_img = np.zeros((H, W), np.float32)
        depth_img[ys, xs] = depth[ys, xs]
        weight_img[ys, xs] = 2.0 * np.exp(-rng.uniform(0.0, 1.0, n_sparse)
                                          ** 2)
        sparse.append(dict(depth_img=depth_img, weight_img=weight_img,
                           coords=np.stack([ys, xs], -1).astype(np.int32),
                           depths=depth[ys, xs], weights=weight_img[ys, xs]))
    zs = np.stack(depths)
    return dict(images=np.stack(images).astype(np.float32), depths=zs,
                dpt=zs.copy(), sparse=sparse, c2ws=c2ws, w2cs=w2cs,
                intrinsic=K, near_far=np.array([zs.min() * 0.8,
                                                zs.max() * 1.2], np.float32),
                bounds=None)


# ------------------------------------------------ the sample contract (copy)

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


def _nearest_resize(img, out_wh):
    """cv2's INTER_NEAREST index law: ``src = floor(dst * in / out)``."""
    h, w = img.shape
    ow, oh = out_wh
    ys = np.minimum((np.arange(oh) * (h / oh)).astype(np.int64), h - 1)
    xs = np.minimum((np.arange(ow) * (w / ow)).astype(np.int64), w - 1)
    return img[ys[:, None], xs[None, :]]


def stage_pyramid(img):
    h, w = img.shape
    return {"stage1": _nearest_resize(img, (w // 4, h // 4)),
            "stage2": _nearest_resize(img, (w // 2, h // 2)),
            "stage3": img}


def split_indices(n_images: int, sample_rate: int = 2):
    ids = np.arange(n_images)
    train_idx = ids[sample_rate // 2::sample_rate]
    test_idx = np.array([i for i in ids if i not in train_idx])
    return train_idx, test_idx


def train_metas(scene: Dict, n_views: int, n_samples: int,
                ds_seed: int) -> List:
    """(ref, srcs) of each train sample: a permutation of the train views
    per sample, from ``default_rng(ds_seed)``."""
    train_idx, _ = split_indices(len(scene["c2ws"]))
    rng = np.random.default_rng(ds_seed)
    out = []
    for _ in range(n_samples):
        sel = rng.permutation(train_idx)
        out.append((int(sel[0]), sel[1:n_views].tolist()))
    return out


def serve_views(scene: Dict, n_views: int, k: int = 0):
    """(ref, srcs) of test view ``k``: its ``n_views - 1`` nearest train
    views by camera-centre distance."""
    train_idx, test_idx = split_indices(len(scene["c2ws"]))
    ref = int(test_idx[k])
    d = np.linalg.norm(scene["c2ws"][ref][:3, 3]
                       - scene["c2ws"][train_idx][:, :3, 3], axis=-1)
    return ref, train_idx[np.argsort(d)[:n_views - 1]].tolist()


def make_sample(scene: Dict, ref: int, srcs, n_depth_rays: int,
                ds_seed: int, epoch: int, idx: int) -> Dict:
    """One fixed-shape sample (numpy), the port's ``SceneDataset
    .__getitem__``: views [ref, *srcs], the sparse-ray subset drawn from
    (ds_seed, epoch, idx)."""
    view_ids = [ref] + list(srcs)
    V = len(view_ids)
    H, W = scene["images"].shape[1:3]
    affs, affs_inv = zip(*(build_affine_mats(scene["intrinsic"],
                                             scene["w2cs"][v])
                           for v in view_ids))
    dg = scene["sparse"][ref]
    weight_img = dg["weight_img"].copy()
    wmin, wmax = weight_img.min(), weight_img.max()
    if wmax > wmin:
        weight_img = (weight_img - wmin) / (wmax - wmin)
    coords = dg["coords"]
    item_rng = np.random.default_rng(np.random.SeedSequence(
        [ds_seed, epoch, idx]))
    sel = coords[item_rng.permutation(len(coords))[:n_depth_rays]]
    pad_coords = np.zeros((n_depth_rays, 2), np.int32)
    pad_coords[:len(sel)] = sel
    mask = np.zeros((n_depth_rays,), np.float32)
    mask[:len(sel)] = 1.0
    sample = dict(
        images=scene["images"][view_ids].astype(np.float32),
        c2ws=scene["c2ws"][view_ids], w2cs=scene["w2cs"][view_ids],
        intrinsics=np.broadcast_to(scene["intrinsic"], (V, 3, 3)).copy(),
        affine_mat=np.stack(affs), affine_mat_inv=np.stack(affs_inv),
        near_fars=np.broadcast_to(scene["near_far"], (V, 2)).copy(),
        depths_h=np.zeros((H, W), np.float32),
        dpt=scene["dpt"][ref], sparse_depths=dg["depth_img"],
        sparse_weights=weight_img.astype(np.float32),
        sparse_coords=pad_coords, sparse_mask=mask,
        view_ids=np.array(view_ids, np.int32), scan_idx=np.int32(0))
    sample["sparse_depth_ms"] = stage_pyramid(sample["sparse_depths"])
    sample["weight_ms"] = stage_pyramid(sample["sparse_weights"])
    return sample


def to_device(sample, device):
    """numpy sample -> dict of tensors on ``device`` (nested dicts kept)."""
    return {k: (to_device(v, device) if isinstance(v, dict)
                else torch.as_tensor(np.asarray(v), device=device))
            for k, v in sample.items()}


# ----------------------------------------------------------------- weights

# dense layers the port draws U(+-1/sqrt(fan_in)) for weight and bias;
# every other dense layer takes a kaiming-normal weight and a zero bias
UNIFORM_DENSE = ("pts_bias_confidence", "alpha_linear_1")


def weight_laws(reference_models) -> List:
    """(group, name, shape, law, scale) of every state-dict entry of the
    reference's (nerf, mvs), in state-dict order.  ``law`` is 'normal',
    'uniform', 'zeros' or 'ones'."""
    import torch.nn as nn
    out = []
    for group, model in zip(("nerf", "mvs"), reference_models):
        laws = {}
        for mname, m in model.named_modules():
            pre = f"{mname}." if mname else ""
            if isinstance(m, nn.Linear):
                fan_in = m.in_features
                if mname.rsplit(".", 1)[-1] in UNIFORM_DENSE:
                    bound = 1.0 / math.sqrt(fan_in)
                    laws[pre + "weight"] = ("uniform", bound)
                    laws[pre + "bias"] = ("uniform", bound)
                else:
                    laws[pre + "weight"] = ("normal", math.sqrt(2.0 / fan_in))
                    laws[pre + "bias"] = ("zeros", 0.0)
            elif isinstance(m, nn.modules.conv._ConvNd):
                w = m.weight
                laws[pre + "weight"] = (
                    "uniform", 1.0 / math.sqrt(w.shape[1]
                                               * math.prod(w.shape[2:])))
                if m.bias is not None:
                    laws[pre + "bias"] = ("zeros", 0.0)
            elif type(m).__name__ == "BatchStatNorm":
                laws[pre + "weight"] = ("ones", 1.0)
                laws[pre + "bias"] = ("zeros", 0.0)
        for name, t in model.state_dict().items():
            law, scale = laws[name]
            out.append((group, name, tuple(t.shape), law, scale))
    return out


def make_weights(laws, seed: int, device) -> Dict[str, Dict]:
    """{'nerf': state dict, 'mvs': state dict} on ``device``: one normal
    and one uniform draw for all leaves, sliced and scaled per leaf."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_int(seed, 2))
    n_normal = sum(math.prod(s) for _, _, s, law, _ in laws
                   if law == "normal")
    n_uniform = sum(math.prod(s) for _, _, s, law, _ in laws
                    if law == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2 - 1
    out = {"nerf": {}, "mvs": {}}
    at = {"normal": 0, "uniform": 0}
    for group, name, shape, law, scale in laws:
        n = math.prod(shape)
        if law in at:
            src = normal if law == "normal" else uniform
            t = src[at[law]:at[law] + n].reshape(shape) * scale
            at[law] += n
        elif law == "ones":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[group][name] = t
    return out


# ------------------------------------------------------------------- draws

def train_draws(seed: int, step: int, *, H: int, W: int, patch_size: int,
                patch_num: int, n_uniform: int, n_rays: int, n_samples: int,
                device) -> SimpleNamespace:
    """The ray draws of train step ``step``, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_int(seed, 3, step))
    u = torch.rand((2, H * W), generator=gen, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return SimpleNamespace(
        gumbel=-torch.log(-torch.log(u)),
        shifts=torch.randint(0, patch_size, (2, 2, patch_num // 2),
                             generator=gen, device=device),
        xs=torch.randint(0, W, (n_uniform,), generator=gen, device=device),
        ys=torch.randint(0, H, (n_uniform,), generator=gen, device=device),
        jitter=torch.rand((n_rays, 3 * (n_samples // 3)), generator=gen,
                          device=device))


# --------------------------------------------------------------- trajectory

def _orthonormal(m):
    u, _, vt = np.linalg.svd(m)
    r = u @ vt
    if np.linalg.det(r) < 0:
        u[:, -1] *= -1
        r = u @ vt
    return r


def trajectory(seed: int, c2ws, n: int) -> np.ndarray:
    """``n`` target poses [n, 4, 4] f32: each a blend, at a drawn weight,
    of two of the scene's cameras drawn at random."""
    rng = _rng(seed, 4)
    pairs = rng.integers(0, len(c2ws), (n, 2))
    ts = rng.uniform(0.0, 1.0, n)
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for k, ((i, j), t) in enumerate(zip(pairs, ts)):
        a, b = c2ws[i].astype(np.float64), c2ws[j].astype(np.float64)
        out[k, :3, :3] = _orthonormal((1 - t) * a[:3, :3] + t * b[:3, :3])
        out[k, :3, 3] = (1 - t) * a[:3, 3] + t * b[:3, 3]
    return out
