"""CascadeMVSNet — the "Consistency Learner" — in PyTorch.

Public layouts are the JAX package's channel-last ones (images
[V-1, H, W, 3], volumes [D, H, W, C]); the convolutions run NCHW / NCDHW
inside.  Module names follow the reference state dict
(``feature.conv0.0.conv``, ``cost_regularization.{s}.conv7.conv``, ...).

- ``FeatureNet``: 3-scale FPN, base 8 channels, stage outputs [32, 16, 8].
  The views run as one batch; BN statistics stay per view
  (``layers.BatchStatNorm``).
- ``CostRegNet``: 3D U-Net, stride-2 down x3, deconv up x3 with skip adds,
  returns (cost_feature, prob_logits).
- Per stage: plane-sweep warp of the source features over D depth
  hypotheses, masked variance with the reference's (n_valid + 1) count,
  CostRegNet, softmax depth expectation, and the photometric confidence
  (4-bin sliding prob mass at the winner index).
- Cascade depth-range propagation: bilinear upsample of the previous depth,
  clamped linspace re-centering, trilinear resize to stage resolution.
- ``dtype`` (``--mvs_dtype``): the compute dtype of the conv blocks
  (``layers.ConvBNReLU``, ``DeconvBNReLU3d``).  The FPN's lateral and output
  convolutions, the CostRegNet's probability convolution and the depth
  hypotheses stay float32, so the variance volume is built from float32
  features, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ucnerf_torch.models.layers import ConvBNReLU, DeconvBNReLU3d
from ucnerf_torch.ops.interpolate import resize_bilinear, resize_trilinear
from ucnerf_torch.ops.warp import homo_warp


class FeatureNet(nn.Module):
    """FPN feature extractor, [V, 3, H, W] -> 3 stage maps (NCHW)."""

    def __init__(self, bc: int = 8, dtype=None):
        super().__init__()
        dt = dict(dtype=dtype)
        self.conv0 = nn.Sequential(ConvBNReLU(3, bc, **dt),
                                   ConvBNReLU(bc, bc, **dt))
        self.conv1 = nn.Sequential(ConvBNReLU(bc, 2 * bc, 5, 2, 2, **dt),
                                   ConvBNReLU(2 * bc, 2 * bc, **dt),
                                   ConvBNReLU(2 * bc, 2 * bc, **dt))
        self.conv2 = nn.Sequential(ConvBNReLU(2 * bc, 4 * bc, 5, 2, 2, **dt),
                                   ConvBNReLU(4 * bc, 4 * bc, **dt),
                                   ConvBNReLU(4 * bc, 4 * bc, **dt))
        self.out1 = nn.Conv2d(4 * bc, 4 * bc, 1, bias=False)
        self.inner1 = nn.Conv2d(2 * bc, 4 * bc, 1, bias=True)
        self.inner2 = nn.Conv2d(bc, 4 * bc, 1, bias=True)
        self.out2 = nn.Conv2d(4 * bc, 2 * bc, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(4 * bc, bc, 3, padding=1, bias=False)

    def forward(self, x):
        c0 = self.conv0(x)
        c1 = self.conv1(c0)
        c2 = self.conv2(c1)
        out = {"stage1": self.out1(c2)}
        intra = F.interpolate(c2, scale_factor=2, mode="nearest") \
            + self.inner1(c1)
        out["stage2"] = self.out2(intra)
        intra = F.interpolate(intra, scale_factor=2, mode="nearest") \
            + self.inner2(c0)
        out["stage3"] = self.out3(intra)
        return out


class CostRegNet(nn.Module):
    """3D U-Net cost regularizer, [1, C, D, H, W] -> (cost [1, bc, ...],
    prob logits [1, 1, ...])."""

    def __init__(self, cin: int, bc: int = 8, dtype=None):
        super().__init__()
        dt = dict(dims=3, dtype=dtype)
        self.conv0 = ConvBNReLU(cin, bc, **dt)
        self.conv1 = ConvBNReLU(bc, 2 * bc, stride=2, **dt)
        self.conv2 = ConvBNReLU(2 * bc, 2 * bc, **dt)
        self.conv3 = ConvBNReLU(2 * bc, 4 * bc, stride=2, **dt)
        self.conv4 = ConvBNReLU(4 * bc, 4 * bc, **dt)
        self.conv5 = ConvBNReLU(4 * bc, 8 * bc, stride=2, **dt)
        self.conv6 = ConvBNReLU(8 * bc, 8 * bc, **dt)
        self.conv7 = DeconvBNReLU3d(8 * bc, 4 * bc, dtype)
        self.conv9 = DeconvBNReLU3d(4 * bc, 2 * bc, dtype)
        self.conv11 = DeconvBNReLU3d(2 * bc, bc, dtype)
        self.prob = nn.Conv3d(bc, 1, 3, padding=1, bias=False)

    def forward(self, x):
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        b = self.conv6(self.conv5(c4))
        b = c4 + self.conv7(b)
        b = c2 + self.conv9(b)
        cost = c0 + self.conv11(b)
        return cost, self.prob(cost)


def _variance_cost_volume(src_feats, projs, depth_values, pad: int):
    """Masked variance volume over source views.

    src_feats [V, H, W, C]; projs [V, 3, 4]; depth_values [D, H_pad, W_pad].
    Returns variance [D, H_pad, W_pad, C].
    """
    vol_sum = 0.0
    vol_sq_sum = 0.0
    mask_sum = torch.ones_like(depth_values)  # the reference's extra +1
    for i in range(src_feats.shape[0]):
        warped, mask = homo_warp(src_feats[i], projs[i], depth_values, pad)
        vol_sum = vol_sum + warped
        vol_sq_sum = vol_sq_sum + warped * warped
        mask_sum = mask_sum + mask
    count = (1.0 / mask_sum)[..., None]
    return vol_sq_sum * count - (vol_sum * count) ** 2


def _sliding_prob_mass4(prob):
    """4-bin sliding sum along depth with (1, 2) zero padding.
    prob [D, H, W] -> [D, H, W]."""
    D = prob.shape[0]
    p = F.pad(prob, (0, 0, 0, 0, 1, 2))
    cs = torch.cumsum(p, dim=0)
    cs = torch.cat([torch.zeros_like(cs[:1]), cs], dim=0)
    return cs[4:4 + D] - cs[0:D]


def _depth_range_samples(cur_depth_hw, ndepth: int, interval, near, far):
    """Re-center depth hypotheses around an upsampled previous depth."""
    dmin = torch.clamp(cur_depth_hw - ndepth / 2 * interval, min=near)
    dmax = torch.clamp(cur_depth_hw + ndepth / 2 * interval, max=far)
    new_interval = (dmax - dmin) / (ndepth - 1)
    steps = torch.arange(ndepth, dtype=cur_depth_hw.dtype,
                         device=cur_depth_hw.device)[:, None, None]
    return dmin[None] + steps * new_interval[None]


def stage_depth_vals(depth_prev, ndepth: int, interval, near, far,
                     H: int, W: int, h: int, w: int, stage_pad: int,
                     depth_values_init):
    """Depth hypotheses [D, h(+2p), w(+2p)] for one cascade stage.
    ``depth_prev`` is the previous stage's depth map (None for stage 1)."""
    if depth_prev is None:
        D0 = depth_values_init.shape[0]
        drs = depth_values_init[:, None, None].expand(D0, H, W)
    else:
        cur = resize_bilinear(depth_prev.detach()[..., None], (H, W))[..., 0]
        drs = _depth_range_samples(cur, ndepth, interval, near, far)
    depth_vals = resize_trilinear(drs[..., None], (ndepth, h, w))[..., 0]
    if stage_pad > 0:
        depth_vals = F.pad(depth_vals[None], (stage_pad,) * 4,
                           mode="replicate")[0]
    return depth_vals


def stage_head(prob_logits, depth_vals, ndepth: int, stage_pad: int,
               h: int, w: int):
    """Softmax prob volume -> (prob, depth, confidence), pad cropped.
    prob_logits [D, h, w]."""
    prob = torch.softmax(prob_logits, dim=0)
    depth = torch.sum(prob * depth_vals, dim=0)
    sum4 = _sliding_prob_mass4(prob)
    idx = torch.sum(prob.detach() * torch.arange(
        ndepth, dtype=prob.dtype, device=prob.device)[:, None, None], dim=0)
    idx = torch.clamp(idx.to(torch.int64), 0, ndepth - 1)
    confidence = torch.clamp(torch.gather(sum4, 0, idx[None])[0], 0.0, 1.0)
    if stage_pad > 0:
        depth = depth[stage_pad:h + stage_pad, stage_pad:w + stage_pad]
        confidence = confidence[stage_pad:h + stage_pad,
                                stage_pad:w + stage_pad]
    return prob, depth, confidence


class CascadeMVSNet(nn.Module):
    """Full 3-stage cascade.

    forward(imgs_src, affine_mats, affine_mats_inv, near, far, pad)
      imgs_src: [V-1, H, W, 3] ImageNet-normalized source views.
      affine_mats / _inv: [V, 3, 4, 4] per-view per-stage K@w2c (view 0 is
        the target view).
      near / far: 0-d float32 tensors.
    Returns a per-stage dict with depth / photometric_confidence /
    volume_feature [D,h,w,8] / depth_values / prob_volume, plus
    img_feats [V-1, H, W, 8].
    """

    def __init__(self, ndepths=(48, 32, 8), depth_intervals_ratio=(4, 2, 1),
                 base_channels: int = 8, cr_base_chs=(8, 8, 8), dtype=None):
        super().__init__()
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)
        self.feature = FeatureNet(base_channels, dtype)
        stage_chs = (4 * base_channels, 2 * base_channels, base_channels)
        self.cost_regularization = nn.ModuleList(
            CostRegNet(stage_chs[si], cr_base_chs[si], dtype)
            for si in range(len(self.ndepths)))

    def features(self, imgs_src):
        """Per-source-view FPN features {stage: [V-1, h, w, C]} —
        target-independent, so serving computes them once."""
        out = self.feature(imgs_src.permute(0, 3, 1, 2))
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}

    def from_features(self, feats, affine_mats, affine_mats_inv, near, far,
                      pad: int = 0):
        """The target-dependent remainder of the cascade given
        ``features``' output."""
        H, W = feats["stage3"].shape[1:3]
        n_stages = len(self.ndepths)
        D0 = self.ndepths[0]
        t = torch.linspace(0.0, 1.0, D0, dtype=torch.float32,
                           device=affine_mats.device)
        depth_values_init = near * (1.0 - t) + far * t
        depth_interval = (far - near) / D0

        outputs = {}
        depth_prev = None
        for si in range(n_stages):
            stage = si + 1
            scale = 2 ** (2 - si)
            ndepth = self.ndepths[si]
            h, w = H // scale, W // scale
            stage_pad = pad if si == n_stages - 1 else 0
            depth_vals = stage_depth_vals(
                depth_prev, ndepth,
                self.depth_intervals_ratio[si] * depth_interval, near, far,
                H, W, h, w, stage_pad, depth_values_init)

            aff = affine_mats[:, si]
            projs = (aff[1:] @ affine_mats_inv[0, si])[:, :3]
            variance = _variance_cost_volume(feats[f"stage{stage}"], projs,
                                             depth_vals, stage_pad)
            cost, prob_logits = self.cost_regularization[si](
                variance.permute(3, 0, 1, 2)[None])
            prob, depth_out, confidence = stage_head(
                prob_logits[0, 0], depth_vals, ndepth, stage_pad, h, w)
            outputs[f"stage{stage}"] = {
                "depth": depth_out,
                "photometric_confidence": confidence,
                "volume_feature": cost[0].permute(1, 2, 3, 0),
                "depth_values": depth_vals,
                "prob_volume": prob.detach(),
            }
            depth_prev = depth_out
        outputs["img_feats"] = feats["stage3"]
        return outputs

    def forward(self, imgs_src, affine_mats, affine_mats_inv, near, far,
                pad: int = 0):
        return self.from_features(self.features(imgs_src), affine_mats,
                                  affine_mats_inv, near, far, pad)
