"""Frozen copy of the port's cascade and NeRF MLP in plain PyTorch.

Copied from ``ucnerf_torch`` (``models/layers.py``, ``models/mvs.py``,
``models/nerf.py``, ``ops/interpolate.py``, ``ops/warp.py``, ``ops/pe.py``)
so that later changes to the program do not move the yardstick.  Module
and parameter names are the program's state-dict names, so one weight
dictionary loads into both.  Departures from the program:

- no view sharding of the cascade (a multi-rank option);
- the MLP's ``dtype`` (bf16) rounds where the program's plain MLP rounds
  (operands, each layer's output after the f32 bias add, the trunk's bias
  product; matmuls accumulated in f32), and ``None`` computes in float32;
- ``operand_round`` (``round_tf32``, ``round_fp8``) rounds the two
  operands of every matmul of a dense layer instead, forward and
  backward, and accumulates in float32 (``RoundedLinear``), which is how
  the benchmark's precision control computes a lower precision on any
  device.

Imports nothing of the program: the benchmark's reference takes only the
inputs the benchmark makes.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def round_tf32(x):
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(x):
    """Round float32 to float8 e4m3 with one scale for the tensor, its
    largest magnitude mapped to e4m3's largest finite value (448), as an
    fp8 matmul scales each operand."""
    scale = 448.0 / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class RoundedLinear(torch.autograd.Function):
    """``x @ w.T + b`` with both operands of each of its three matmuls
    (forward, input gradient, weight gradient) rounded by ``q``."""

    @staticmethod
    def forward(ctx, x, w, b, q):
        qx, qw = q(x), q(w)
        ctx.save_for_backward(qx, qw)
        ctx.q = q
        return qx @ qw.T + b

    @staticmethod
    def backward(ctx, gy):
        qx, qw = ctx.saved_tensors
        qg = ctx.q(gy)
        gx = qg @ qw
        gw = qg.reshape(-1, qg.shape[-1]).T @ qx.reshape(-1, qx.shape[-1])
        return gx, gw, gy.reshape(-1, gy.shape[-1]).sum(0), None


# ---- layers

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


def _low(conv: nn.Module, x, dtype):
    """(input, weight) of ``conv`` cast to the compute dtype, if any."""
    if dtype is None:
        return x, conv.weight
    return x.to(dtype), conv.weight.to(dtype)


class ConvBNReLU(nn.Module):
    """Conv{2,3}d (no bias) + BatchStatNorm + ReLU, named like the
    reference blocks (``.conv``, ``.bn``); the convolution runs in
    ``dtype`` when it is given."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, dims: int = 2, dtype=None):
        super().__init__()
        conv = nn.Conv3d if dims == 3 else nn.Conv2d
        self.conv = conv(cin, cout, kernel, stride=stride, padding=padding,
                         bias=False)
        self.bn = BatchStatNorm(cout)
        self.dtype = dtype

    def forward(self, x):
        y = self.conv._conv_forward(*_low(self.conv, x, self.dtype), None)
        return F.relu(self.bn(y.float()))


class DeconvBNReLU3d(nn.Module):
    """ConvTranspose3d (k3, s2, p1, output_padding 1, no bias) + BN + ReLU;
    the transposed convolution runs in ``dtype`` when it is given."""

    def __init__(self, cin: int, cout: int, dtype=None):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                                       output_padding=1, bias=False)
        self.bn = BatchStatNorm(cout)
        self.dtype = dtype

    def forward(self, x):
        x, w = _low(self.conv, x, self.dtype)
        y = F.conv_transpose3d(x, w, stride=2, padding=1, output_padding=1)
        return F.relu(self.bn(y.float()))


# ---- resizes

def resize_bilinear(x, out_hw):
    """Bilinear resize of ``x [H, W, C]`` to ``out_hw=(H', W')``."""
    y = F.interpolate(x.permute(2, 0, 1)[None], size=tuple(out_hw),
                      mode="bilinear", align_corners=False)
    return y[0].permute(1, 2, 0)


def resize_trilinear(x, out_dhw):
    """Trilinear resize of ``x [D, H, W, C]`` to ``out_dhw=(D', H', W')``."""
    y = F.interpolate(x.permute(3, 0, 1, 2)[None], size=tuple(out_dhw),
                      mode="trilinear", align_corners=False)
    return y[0].permute(1, 2, 3, 0)


# ---- plane-sweep warp

def homo_warp(src_feat, proj_mat, depth_values, pad: int = 0):
    """Warp one source feature map into the target frustum's plane sweep.

    src_feat [H, W, C]; proj_mat [3, 4] rows [R | T]; depth_values
    [D, H_pad, W_pad] (already padded if pad > 0).
    Returns (warped [D, H_pad, W_pad, C], mask [D, H_pad, W_pad]).
    """
    H, W, C = src_feat.shape
    _, H_pad, W_pad = depth_values.shape
    R = proj_mat[:, :3]
    T = proj_mat[:, 3]
    dev, dt = src_feat.device, src_feat.dtype

    ys = torch.arange(H_pad, dtype=dt, device=dev) - pad
    xs = torch.arange(W_pad, dtype=dt, device=dev) - pad
    base = (R[:, 0][:, None, None] * xs[None, None, :]
            + R[:, 1][:, None, None] * ys[None, :, None]
            + R[:, 2][:, None, None])                       # [3, H_pad, W_pad]
    src = base[:, None] + T[:, None, None, None] / depth_values[None]
    u = src[0] / src[2]
    v = src[1] / src[2]

    gx = u / ((W - 1) / 2.0) - 1.0
    gy = v / ((H - 1) / 2.0) - 1.0
    in_mask = (gx > -1.0) & (gx < 1.0) & (gy > -1.0) & (gy < 1.0)

    ix = torch.clamp(torch.round((gx + 1.0) * 0.5 * (W - 1)), 0, W - 1)
    iy = torch.clamp(torch.round((gy + 1.0) * 0.5 * (H - 1)), 0, H - 1)
    idx = iy.long() * W + ix.long()
    warped = src_feat.reshape(H * W, C)[idx]
    return warped, in_mask.to(dt)


# ---- cascade

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
    mask_sum = 0.0
    for i in range(src_feats.shape[0]):
        warped, mask = homo_warp(src_feats[i], projs[i], depth_values, pad)
        vol_sum = vol_sum + warped
        vol_sq_sum = vol_sq_sum + warped * warped
        mask_sum = mask_sum + mask
    # the reference's extra +1 in the in-bounds count; the masks are 0 or
    # 1, so the count is exact in any order of the sums
    count = (1.0 / (1.0 + mask_sum))[..., None]
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


# ---- positional encoding

def pe_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """x [..., d] -> [..., d*(1+2*multires)]."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    scaled = (x[..., None, :] * freqs[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(scaled), torch.cos(scaled)], dim=-1)


# ---- MLP

class BaseAdaptRenderer(nn.Module):
    """The conditional dual-head uncertainty-blended MLP (the program's
    ``models/nerf.py::BaseAdaptRenderer``), in float32 or rounded to
    ``dtype`` where the program rounds.

      depth_bias = Linear(24+4(V-1) -> W)([mvs, colors])
      feats_bias = Linear(8(V-1) -> W)(img_feats)
      trunk: h = relu(linear_i(h) * depth_bias); skip-concat pe(pts) after 4
      base:  base_rgb = Linear(W->3)(h); base_a = Linear(W->1)(h)
      adapt: f = Linear(W->W)(h * feats_bias); h1 = [f, pe(dirs)]
      blend (u = 1 - confidence):
             rgb   = sigmoid(base_rgb*(1-u) + adapt_rgb*u)
             alpha = relu  (adapt_a  *(1-u) + base_a  *u)
    """

    def __init__(self, depth: int = 6, width: int = 128, in_ch_pts: int = 63,
                 in_ch_views: int = 27, view_num: int = 7,
                 skips=(4,), operand_round=None, dtype=None):
        super().__init__()
        v1 = view_num - 1
        self.depth, self.width, self.view_num = depth, width, view_num
        self.skips = tuple(skips)
        self.operand_round = operand_round
        self.dtype = dtype
        self.pts_bias_depth_fine = nn.Linear(24 + 4 * v1, width)
        self.pts_bias_confidence = nn.Linear(8 * v1, width)
        fan_ins = [in_ch_pts] + [width + in_ch_pts if i - 1 in self.skips
                                 else width for i in range(1, depth)]
        self.pts_linears = nn.ModuleList(nn.Linear(f, width)
                                         for f in fan_ins)
        self.confi_rgb_linear = nn.Linear(width, 3)
        self.alpha_linear_1 = nn.Linear(width, 1)
        self.feature_linear = nn.Linear(width, width)
        self.views_linears = nn.ModuleList(
            [nn.Linear(width + in_ch_views, width // 2)])
        self.view_confi_linears = nn.ModuleList(
            [nn.Linear(width + in_ch_views, width // 2)])
        self.rgb_linear = nn.Linear(width // 2, 3)
        self.alpha_linear = nn.Linear(width // 2, 1)

    def _round(self, x):
        return x if self.dtype is None else x.to(self.dtype).float()

    def _dense(self, x, layer):
        q = self.operand_round
        if q is not None:
            return RoundedLinear.apply(x, layer.weight, layer.bias, q)
        return self._round(F.linear(x, self._round(layer.weight),
                                    layer.bias))

    def forward(self, pts, feats, views):
        """pts [..., 63], feats [..., feat_dim], views [..., 27] ->
        [..., 4]."""
        r, dense = self._round, self._dense
        v1 = self.view_num - 1
        mvs_colors = r(feats[..., :24 + 4 * v1])
        img_feats = r(feats[..., 24 + 4 * v1:24 + 12 * v1])
        u = 1.0 - feats[..., -1:]

        depth_bias = dense(mvs_colors, self.pts_bias_depth_fine)
        feats_bias = dense(img_feats, self.pts_bias_confidence)

        pts = r(pts)
        h = pts
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(r(dense(h, layer) * depth_bias))
            if i in self.skips:
                h = torch.cat([pts, h], dim=-1)

        base_rgb = dense(h, self.confi_rgb_linear)
        base_a = dense(h, self.alpha_linear_1)

        feature = dense(r(h * feats_bias), self.feature_linear)
        h1 = torch.cat([feature, r(views)], dim=-1)
        adapt_rgb = dense(F.relu(dense(h1, self.views_linears[0])),
                          self.rgb_linear)
        adapt_a = dense(F.relu(dense(h1, self.view_confi_linears[0])),
                        self.alpha_linear)

        rgb = torch.sigmoid(base_rgb * (1.0 - u) + adapt_rgb * u)
        alpha = F.relu(adapt_a * (1.0 - u) + base_a * u)
        return torch.cat([rgb, alpha], dim=-1)


class UCNeRFMLP(nn.Module):
    """Positional encodings, then the dual-head MLP."""

    def __init__(self, depth: int = 6, width: int = 128, multires: int = 10,
                 multires_views: int = 4, view_num: int = 7, skips=(4,),
                 operand_round=None, dtype=None):
        super().__init__()
        self.multires, self.multires_views = multires, multires_views
        self.nerf = BaseAdaptRenderer(
            depth=depth, width=width, in_ch_pts=pe_dim(multires),
            in_ch_views=pe_dim(multires_views), view_num=view_num,
            skips=skips, operand_round=operand_round, dtype=dtype)

    def forward(self, pts, viewdirs, feats):
        """pts [N, S, 3] (NDC), viewdirs [N, 3], feats [N, S, feat_dim]."""
        pe_pts = positional_encoding(pts, self.multires)
        pe_dirs = positional_encoding(viewdirs, self.multires_views)
        pe_dirs = pe_dirs[:, None, :].expand(*pts.shape[:2], pe_dirs.shape[-1])
        return self.nerf(pe_pts, feats, pe_dirs)
