"""LPIPS (AlexNet, v0.1) in torch, the port of ``ucnerf_tpu.eval.lpips``.

The reference computes LPIPS with the ``lpips`` pip package
(``utils/evaluation.py:84-87``): inputs scaled to [-1, 1], the scaling
layer, AlexNet's convolutions tapped after each ReLU, unit-normalized over
channels (eps added to the norm, outside the sqrt), squared difference, 1x1
linear heads, spatial mean, summed over the taps.

The weights are the JAX package's npz (``convert_weights.py lpips``): conv
kernels (kh, kw, Cin, Cout), biases, and one [C] head per tap.  They are not
in the repository; without the file ``load_lpips`` returns None and the
evaluation reports LPIPS as nan.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet feature config: (out_ch, kernel, stride, pad), a tap after each
# ReLU block (torchvision alexnet.features, as lpips slices it)
_ALEX_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
             (256, 3, 1, 1), (256, 3, 1, 1)]
_MAXPOOL_AFTER = {0, 1}          # maxpool(3, stride 2) after taps 0 and 1
# lpips 'scaling layer' constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
DEFAULT_PATH = "pretrained_weights/lpips_alex.npz"


def lpips_weights(npz_weights, device="cpu") -> Dict[str, torch.Tensor]:
    """The npz layout -> torch tensors on ``device``: conv kernels as
    (Cout, Cin, kh, kw), biases and heads as they are."""
    out = {}
    for k, v in npz_weights.items():
        t = torch.as_tensor(np.asarray(v, np.float32), device=device)
        out[k] = t.permute(3, 2, 0, 1).contiguous() if k.endswith("_w") \
            and t.ndim == 4 else t
    return out


def lpips_distance(weights: Dict[str, torch.Tensor], img0, img1):
    """img0 / img1 [H, W, 3] in [0, 1] -> scalar LPIPS distance;
    ``weights`` from ``lpips_weights``."""
    dev = weights["conv0_w"].device
    shift = torch.tensor(_SHIFT, device=dev).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=dev).view(1, 3, 1, 1)

    def feats(img):
        x = torch.as_tensor(img, dtype=torch.float32, device=dev)
        x = x.permute(2, 0, 1)[None] * 2.0 - 1.0
        x = (x - shift) / scale
        taps = []
        for i, (_, _, stride, pad) in enumerate(_ALEX_CFG):
            x = F.relu(F.conv2d(x, weights[f"conv{i}_w"],
                                weights[f"conv{i}_b"], stride=stride,
                                padding=pad))
            taps.append(x)
            if i in _MAXPOOL_AFTER:
                x = F.max_pool2d(x, 3, stride=2)
        return taps

    total = torch.zeros((), device=dev)
    with torch.no_grad():
        for i, (a, b) in enumerate(zip(feats(img0), feats(img1))):
            # lpips normalize_tensor: eps on the norm, outside the sqrt
            a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True))
                     + 1e-10)
            b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True))
                     + 1e-10)
            d = (a - b) ** 2
            lin = weights[f"lin{i}_w"].view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d * lin, dim=1))
    return total


def load_lpips(weights_path: Optional[str] = None, device="cpu"):
    """``lpips_fn(img0, img1) -> float`` on ``device``, or None when the
    weight file (``weights_path``, else ``$UCNERF_LPIPS_WEIGHTS``, else
    ``pretrained_weights/lpips_alex.npz``) does not exist."""
    if weights_path is None:
        weights_path = os.environ.get("UCNERF_LPIPS_WEIGHTS", DEFAULT_PATH)
    if not os.path.exists(weights_path):
        return None
    with np.load(weights_path) as data:
        weights = lpips_weights({k: data[k] for k in data.files}, device)
    return lambda a, b: float(lpips_distance(weights, a, b))
