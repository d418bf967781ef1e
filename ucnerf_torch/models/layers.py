"""Building-block layers with the JAX package's semantics.

- Explicit symmetric padding ``(p, p)`` per spatial dim (torch's own rule).
- Batch-statistics normalization: the reference always runs its nets in
  train mode, so BN always normalizes with the current statistics (biased
  variance, eps 1e-5) and never with running averages.  The JAX package
  vmaps its per-view FeatureNet, so each view is its own BN batch; here a
  batch of views is one tensor, and ``BatchStatNorm`` normalizes each
  sample of the batch with its own statistics (``instance_norm`` with a
  per-channel affine), which is BN for a batch of one.  The cost volumes
  run with a batch of one.
- ``TorchDense``: ``nn.Linear`` whose init law is chosen by the factory.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchStatNorm(nn.Module):
    """Per-sample batch-statistics BN with learnable scale/shift; holds no
    running statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               use_input_stats=True, eps=self.eps)


class ConvBNReLU(nn.Module):
    """Conv{2,3}d (no bias) + BatchStatNorm + ReLU, named like the
    reference blocks (``.conv``, ``.bn``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, dims: int = 2):
        super().__init__()
        conv = nn.Conv3d if dims == 3 else nn.Conv2d
        self.conv = conv(cin, cout, kernel, stride=stride, padding=padding,
                         bias=False)
        self.bn = BatchStatNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DeconvBNReLU3d(nn.Module):
    """ConvTranspose3d (k3, s2, p1, output_padding 1, no bias) + BN + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                                       output_padding=1, bias=False)
        self.bn = BatchStatNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class TorchDense(nn.Linear):
    """``nn.Linear`` that records which init law the reference gives it:
    ``kaiming=True`` -> kaiming-normal weight, zero bias; ``False`` -> torch
    default U(±1/sqrt(fan_in)) for both (``models.factory.init_params``)."""

    def __init__(self, fan_in: int, features: int, kaiming: bool = True):
        super().__init__(fan_in, features)
        self.kaiming = kaiming
