"""The conditional dual-head (base/adaptive) uncertainty-blended NeRF MLP,
in plain PyTorch.  This is the plain version of the fused MLP kernel
(``kernels/fused_mlp.py``): the CPU path, and the yardstick the kernel is
held against on the card.

  input x = [pe(pts) 63 | feats | pe(dirs) 27]
  feats   = [mvs 24 | warped colors 4*(V-1) | img feats 8*(V-1) | confidence 1]

  depth_bias = Linear(24+4(V-1) -> W)([mvs, colors])
  feats_bias = Linear(8(V-1) -> W)(img_feats)
  trunk:   h = relu(linear_i(h) * depth_bias); skip-concat pe(pts) after layer 4
  base:    base_rgb = Linear(W->3)(h); base_a = Linear(W->1)(h)
  adapt:   f = Linear(W->W)(h * feats_bias); h1 = [f, pe(dirs)]
           adapt_rgb = Linear(W/2->3)(relu(Linear(h1)))
           adapt_a   = Linear(W/2->1)(relu(Linear(h1)))
  blend (u = 1 - confidence; the asymmetry is the reference's):
           rgb   = sigmoid(base_rgb*(1-u) + adapt_rgb*u)
           alpha = relu  (adapt_a  *(1-u) + base_a  *u)

``dtype=torch.bfloat16`` rounds where the JAX package's fused kernel
rounds: operands and every layer's output (after the f32 bias add) to
bf16, the trunk's bias product to bf16, matmuls accumulated in f32, the
blend in f32.  Module names follow the reference state dict
(``nerf.pts_linears.{i}``, ``nerf.views_linears.0``, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ucnerf_torch.models.layers import TorchDense
from ucnerf_torch.ops.pe import pe_dim, positional_encoding


class BaseAdaptRenderer(nn.Module):

    def __init__(self, depth: int = 6, width: int = 128, in_ch_pts: int = 63,
                 in_ch_views: int = 27, view_num: int = 7,
                 skips=(4,), dtype=None):
        super().__init__()
        v1 = view_num - 1
        self.depth, self.width, self.view_num = depth, width, view_num
        self.skips = tuple(skips)
        self.dtype = dtype
        self.pts_bias_depth_fine = TorchDense(24 + 4 * v1, width)
        self.pts_bias_confidence = TorchDense(8 * v1, width, kaiming=False)
        fan_ins = [in_ch_pts] + [width + in_ch_pts if i - 1 in self.skips
                                 else width for i in range(1, depth)]
        self.pts_linears = nn.ModuleList(TorchDense(f, width)
                                         for f in fan_ins)
        self.confi_rgb_linear = TorchDense(width, 3)
        self.alpha_linear_1 = TorchDense(width, 1, kaiming=False)
        self.feature_linear = TorchDense(width, width)
        self.views_linears = nn.ModuleList(
            [TorchDense(width + in_ch_views, width // 2)])
        self.view_confi_linears = nn.ModuleList(
            [TorchDense(width + in_ch_views, width // 2)])
        self.rgb_linear = TorchDense(width // 2, 3)
        self.alpha_linear = TorchDense(width // 2, 1)

    def _round(self, x):
        return x if self.dtype is None else x.to(self.dtype).float()

    def _dense(self, x, layer):
        return self._round(F.linear(x, self._round(layer.weight),
                                    layer.bias))

    def forward(self, pts, feats, views):
        """pts [..., 63], feats [..., feat_dim], views [..., 27] -> [..., 4]."""
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
                 dtype=None):
        super().__init__()
        self.multires, self.multires_views = multires, multires_views
        self.nerf = BaseAdaptRenderer(
            depth=depth, width=width, in_ch_pts=pe_dim(multires),
            in_ch_views=pe_dim(multires_views), view_num=view_num,
            skips=skips, dtype=dtype)

    def forward(self, pts, viewdirs, feats):
        """pts [N, S, 3] (NDC), viewdirs [N, 3], feats [N, S, feat_dim]."""
        pe_pts = positional_encoding(pts, self.multires)
        pe_dirs = positional_encoding(viewdirs, self.multires_views)
        pe_dirs = pe_dirs[:, None, :].expand(*pts.shape[:2], pe_dirs.shape[-1])
        return self.nerf(pe_pts, feats, pe_dirs)
