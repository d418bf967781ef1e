"""DPT-Hybrid monocular depth and ADE20K segmentation: the port of
``ucnerf_tpu.models.dpt``.

The network is the reference's offline depth prior
(``preprocess/DPT/run_monodepth.py``; transformers' hybrid MiDaS
``DPTForDepthEstimation``):
- a BiT stem (ResNet-v2 bottlenecks with weight-standardized convolutions,
  GroupNorm-32 and TF-SAME padding) and 3 stages giving maps at /4 (256),
  /8 (512) and /16 (1024);
- a 1x1 projection to 768 tokens, a cls token and bilinearly resized
  position embeddings, 12 pre-LN ViT layers (12 heads, exact GELU) with
  hooks after layers 8 and 11;
- a reassemble neck (projected readout) and a 4-level fusion decoder
  (pre-activated residual units, x2 align_corners=True upsampling), then
  the depth head or the segmentation head.

Parameters are a flat dict keyed by transformers' state-dict names, held
in torch layouts on the device.  Files in the JAX package's layouts
(``convert_dpt_torch_state_dict``: convolutions HWIO, linears (in, out))
are transposed once at load, so either package reads the other's weights.
The functions keep the JAX module's names; inside they are NCHW and
batched (``img [N, 3, H, W]``).  Convolutions and matrix products are
cuDNN's and cuBLAS's (``F.conv2d``, ``torch.matmul``): the JAX package
computes this network with XLA, outside any Pallas kernel.

``dtype="bfloat16"`` rounds every float parameter to bf16, norm scales and
BN running statistics included, as ``_load_converted_params`` of the JAX
package does; normalization statistics, softmax and the outputs stay f32.
"""

from __future__ import annotations

import math
import os
import zlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ucnerf_torch.ops.interpolate import resize_bicubic, resize_bilinear
from ucnerf_torch.utils.platform import resolve_device

HIDDEN = 768
N_LAYERS = 12
N_HEADS = 12
FUSION = 256
HOOKS = (8, 11)            # transformer layer outputs feeding the neck
BIT_DEPTHS = (3, 4, 9)
BIT_CHANNELS = (256, 512, 1024)
BIT = "dpt.embeddings.backbone.bit."
ADE20K_LABELS = 150
BIT_BRANCH_SCALE = 0.1     # seeded weights: the residual branches' scale


# ------------------------------------------------------------ primitive ops
def _tf_same_pad(x, k: int, s: int):
    """TF 'SAME' dynamic padding with zeros (transformers
    ``BitDynamicPad2d``) of ``x [N, C, H, W]``."""
    h, w = x.shape[-2:]
    ph = max((math.ceil(h / s) - 1) * s + k - h, 0)
    pw = max((math.ceil(w / s) - 1) * s + k - w, 0)
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def conv2d(x, w, b=None, stride: int = 1, pad: int = 0):
    """x [N, C, H, W], w [O, I, kh, kw]; symmetric integer padding."""
    return F.conv2d(x, w, b, stride=stride, padding=pad)


def standardize_weight(w, eps: float = 1e-8):
    """BiT ``WeightStandardizedConv2d``'s kernel: per output channel, mean
    0 and biased variance 1, computed in f32 whatever ``w``'s dtype."""
    wf = w.float()
    mean = wf.mean(dim=(1, 2, 3), keepdim=True)
    var = wf.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
    return (wf - mean) * torch.rsqrt(var + eps)


def ws_conv2d(x, w, stride: int = 1):
    """Weight-standardized conv with TF-SAME padding.  ``w`` is already
    standardized: ``to_torch_params`` runs ``standardize_weight`` once at
    load and casts to the working dtype, which gives the numbers the JAX
    package computes in every forward."""
    k = w.shape[-1]
    if stride == 1:
        return conv2d(x, w, pad=(k - 1) // 2)
    return conv2d(_tf_same_pad(x, k, stride), w, stride=stride)


def group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5):
    """torch GroupNorm with statistics in f32; result in x's dtype."""
    return F.group_norm(x.float(), groups, scale.float(), bias.float(),
                        eps).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-12):
    """LayerNorm over the last axis with transformers' ViT eps (1e-12),
    statistics in f32; result in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                        eps).to(x.dtype)


def max_pool_same(x, k: int = 3, s: int = 2):
    return F.max_pool2d(_tf_same_pad(x, k, s), k, s)


def resize_bilinear_ac(x, out_hw):
    """align_corners=True bilinear resize of ``x [N, C, H, W]``, lerped in
    f32 and cast back to x's dtype."""
    return F.interpolate(x.float(), size=tuple(out_hw), mode="bilinear",
                         align_corners=True).to(x.dtype)


# ------------------------------------------------------------ BiT backbone
def _bit_bottleneck(p, prefix, x, stride: int, first: bool):
    shortcut = x
    if first:
        shortcut = ws_conv2d(x, p[prefix + "downsample.conv.weight"],
                             stride=stride)
        shortcut = group_norm(shortcut, p[prefix + "downsample.norm.weight"],
                              p[prefix + "downsample.norm.bias"])
    h = ws_conv2d(x, p[prefix + "conv1.weight"])
    h = F.relu(group_norm(h, p[prefix + "norm1.weight"],
                          p[prefix + "norm1.bias"]))
    h = ws_conv2d(h, p[prefix + "conv2.weight"], stride=stride)
    h = F.relu(group_norm(h, p[prefix + "norm2.weight"],
                          p[prefix + "norm2.bias"]))
    h = ws_conv2d(h, p[prefix + "conv3.weight"])
    h = group_norm(h, p[prefix + "norm3.weight"], p[prefix + "norm3.bias"])
    return F.relu(h + shortcut)


def _bit_forward(p, img):
    """img [N, 3, H, W] -> (feat_4 [N, 256, .], feat_8 [N, 512, .],
    feat_16 [N, 1024, .])"""
    x = ws_conv2d(img, p[BIT + "embedder.convolution.weight"], stride=2)
    x = F.relu(group_norm(x, p[BIT + "embedder.norm.weight"],
                          p[BIT + "embedder.norm.bias"]))
    x = max_pool_same(x)
    feats = []
    for si, depth in enumerate(BIT_DEPTHS):
        stride = 1 if si == 0 else 2
        for li in range(depth):
            prefix = BIT + f"encoder.stages.{si}.layers.{li}."
            x = _bit_bottleneck(p, prefix, x, stride if li == 0 else 1,
                                first=li == 0)
        feats.append(x)
    return feats


# ------------------------------------------------------------ ViT encoder
def _linear(p, name, x):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def _attention(p, prefix, x):
    """Multi-head self-attention of ``x [N, T, C]`` as plain matrix
    products, the softmax in f32 whatever the working dtype."""
    n, t, c = x.shape
    hd = c // N_HEADS

    def proj(name):
        return _linear(p, prefix + f"attention.attention.{name}", x).view(
            n, t, N_HEADS, hd).transpose(1, 2)

    q, k, v = proj("query"), proj("key"), proj("value")
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    att = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = (att @ v).transpose(1, 2).reshape(n, t, c)
    return _linear(p, prefix + "attention.output.dense", out)


def _vit_layer(p, prefix, x):
    h = layer_norm(x, p[prefix + "layernorm_before.weight"],
                   p[prefix + "layernorm_before.bias"])
    x = x + _attention(p, prefix, h)
    h = layer_norm(x, p[prefix + "layernorm_after.weight"],
                   p[prefix + "layernorm_after.bias"])
    h = F.gelu(_linear(p, prefix + "intermediate.dense", h),
               approximate="none")
    return x + _linear(p, prefix + "output.dense", h)


def _resize_pos_embed(pos, gh: int, gw: int):
    """pos [1+N, C] -> [1+gh*gw, C] in f32: the grid part resized
    bilinearly (align_corners=False)."""
    tok, grid = pos[:1].float(), pos[1:].float()
    old = int(round(math.sqrt(grid.shape[0])))
    grid = resize_bilinear(grid.reshape(old, old, -1), (gh, gw))
    return torch.cat([tok, grid.reshape(gh * gw, -1)], dim=0)


# ------------------------------------------------------------ neck + head
def _readout_project(p, idx, tokens, cls):
    t = torch.cat([tokens, cls.expand_as(tokens)], dim=-1)
    return F.gelu(_linear(p, f"neck.reassemble_stage.readout_projects."
                          f"{idx}.0", t), approximate="none")


def batch_norm_inf(x, p, prefix, eps: float = 1e-5):
    """Inference-mode BatchNorm2d (running statistics), the affine math in
    f32, the result in x's dtype."""
    return F.batch_norm(x.float(), p[prefix + "running_mean"].float(),
                        p[prefix + "running_var"].float(),
                        p[prefix + "weight"].float(),
                        p[prefix + "bias"].float(), False, 0.0,
                        eps).to(x.dtype)


def _pre_act_residual(p, prefix, x):
    """Pre-activated residual unit.  The segmentation model's units BN each
    conv and have no conv biases (transformers
    ``use_batch_norm_in_fusion_residual``); that is read from the
    parameter keys, so depth and segmentation share this code."""
    use_bn = prefix + "batch_norm1.running_mean" in p

    def conv(h, i):
        h = conv2d(h, p[prefix + f"convolution{i}.weight"],
                   p.get(prefix + f"convolution{i}.bias"), pad=1)
        if use_bn:
            h = batch_norm_inf(h, p, prefix + f"batch_norm{i}.")
        return h

    h = conv(F.relu(x), 1)
    h = conv(F.relu(h), 2)
    return x + h


def _fusion_layer(p, idx, x, residual=None):
    prefix = f"neck.fusion_stage.layers.{idx}."
    if residual is not None:
        if residual.shape[-2:] != x.shape[-2:]:
            residual = F.interpolate(residual.float(), size=x.shape[-2:],
                                     mode="bilinear",
                                     align_corners=False).to(x.dtype)
        x = x + _pre_act_residual(p, prefix + "residual_layer1.", residual)
    x = _pre_act_residual(p, prefix + "residual_layer2.", x)
    x = resize_bilinear_ac(x, (x.shape[-2] * 2, x.shape[-1] * 2))
    return conv2d(x, p[prefix + "projection.weight"],
                  p[prefix + "projection.bias"])


def _dpt_trunk(p: Dict[str, torch.Tensor], img):
    """Shared DPT-hybrid trunk: BiT + ViT -> reassemble -> fusion decoder.
    img [N, 3, H, W] (H, W multiples of 16, normalized) -> the fused map
    [N, FUSION, H/2, W/2] (the decoder's ``path_1``)."""
    f4, f8, f16 = _bit_forward(p, img)
    n, _, gh, gw = f16.shape
    tokens = conv2d(f16, p["dpt.embeddings.projection.weight"],
                    p["dpt.embeddings.projection.bias"]
                    ).flatten(2).transpose(1, 2)
    cls = p["dpt.embeddings.cls_token"].reshape(1, 1, HIDDEN).expand(
        n, 1, HIDDEN)
    x = torch.cat([cls, tokens], dim=1)
    x = x + _resize_pos_embed(
        p["dpt.embeddings.position_embeddings"].reshape(-1, HIDDEN),
        gh, gw).to(x.dtype)

    hooks = {}
    for li in range(N_LAYERS):
        x = _vit_layer(p, f"dpt.encoder.layer.{li}.", x)
        if li in HOOKS:
            hooks[li] = x

    # reassemble hooks 2/3 (hybrid: levels 0/1 are the BiT maps, identity)
    feats = [f4, f8]
    for out_i, li in zip((2, 3), HOOKS):
        h = hooks[li]
        t = _readout_project(p, out_i, h[:, 1:], h[:, :1])
        fm = t.transpose(1, 2).reshape(n, HIDDEN, gh, gw)
        pre = f"neck.reassemble_stage.layers.{out_i}."
        fm = conv2d(fm, p[pre + "projection.weight"],
                    p[pre + "projection.bias"])
        if out_i == 3:      # factor 0.5 -> 3x3 stride-2 conv
            fm = conv2d(fm, p[pre + "resize.weight"], p[pre + "resize.bias"],
                        stride=2, pad=1)
        feats.append(fm)

    feats = [conv2d(f, p[f"neck.convs.{i}.weight"], pad=1)
             for i, f in enumerate(feats)]

    # fusion: start from the deepest level
    fused = _fusion_layer(p, 0, feats[3])
    fused = _fusion_layer(p, 1, fused, feats[2])
    fused = _fusion_layer(p, 2, fused, feats[1])
    return _fusion_layer(p, 3, fused, feats[0])


def dpt_forward(p: Dict[str, torch.Tensor], img):
    """img [N, 3, H, W] (H, W multiples of 16, normalized) -> inverse-depth
    prediction [N, H, W] f32 (MiDaS convention)."""
    return _depth_head(p, _dpt_trunk(p, img))


def _depth_head(p, fused):
    """The trunk's map [N, FUSION, H/2, W/2] -> inverse depth [N, H, W]."""
    h = conv2d(fused, p["head.head.0.weight"], p["head.head.0.bias"], pad=1)
    h = resize_bilinear_ac(h, (h.shape[-2] * 2, h.shape[-1] * 2))
    h = F.relu(conv2d(h, p["head.head.2.weight"], p["head.head.2.bias"],
                      pad=1))
    h = F.relu(conv2d(h, p["head.head.4.weight"], p["head.head.4.bias"]))
    return h[:, 0].float()


def dpt_seg_forward(p: Dict[str, torch.Tensor], img):
    """Segmentation head on the shared trunk (transformers
    ``DPTForSemanticSegmentation``; the training-only auxiliary head is not
    evaluated): conv3x3 (no bias) -> BN -> ReLU -> conv1x1 -> x2 bilinear
    align_corners=True.  img [N, 3, H, W] normalized -> logits
    [N, num_labels, H, W] f32."""
    fused = _dpt_trunk(p, img)
    h = conv2d(fused, p["head.head.0.weight"], pad=1)
    h = F.relu(batch_norm_inf(h, p, "head.head.1."))
    h = conv2d(h, p["head.head.4.weight"], p["head.head.4.bias"])
    return resize_bilinear_ac(h, (h.shape[-2] * 2,
                                  h.shape[-1] * 2)).float()


# ------------------------------------------------------------ weights
def convert_dpt_torch_state_dict(sd) -> Dict[str, np.ndarray]:
    """transformers DPT (hybrid) state dict -> the JAX package's layouts,
    every array f32: conv (O, I, kh, kw) -> (kh, kw, I, O); linear (O, I)
    -> (I, O)."""
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        if k.endswith("weight") and v.ndim == 4:
            v = np.transpose(v, (2, 3, 1, 0))
        elif k.endswith("weight") and v.ndim == 2:
            v = v.T
        out[k] = v.astype(np.float32)
    return out


def _torch_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def to_torch_params(params, dtype=None, device="cpu") -> Dict[str,
                                                              torch.Tensor]:
    """Params in the JAX layouts (``convert_dpt_torch_state_dict``) ->
    torch tensors in torch layouts on ``device``.  Every float array is
    cast to ``dtype`` (default f32); the BiT kernels are then
    standardized in f32 from the cast values and cast again, which is what
    the JAX forward computes from the same parameters."""
    dt = _torch_dtype(dtype)
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(np.asarray(v))
        if k.endswith("weight") and t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        elif k.endswith("weight") and t.ndim == 2:
            t = t.T
        # contiguous first: the standardization's sums then run in one
        # order whatever layout the file held
        t = t.contiguous()
        if t.is_floating_point():
            t = t.to(dt)
            if k.startswith(BIT) and t.ndim == 4:
                t = standardize_weight(t).to(dt)
        out[k] = t.to(device)
    return out


def _load_converted_params(weights_path, env_var, default_path, dtype=None,
                           device="cpu"):
    """Weights from ``weights_path``, else ``$env_var``, else
    ``default_path``: a torch ``.pt/.pth/.bin`` state dict (converted on
    the fly) or an npz in the JAX layouts (``python -m
    ucnerf_torch.convert_weights dpt|dpt_seg`` or the JAX package's
    ``convert_weights.py``); returned as ``to_torch_params`` gives them."""
    if weights_path is None:
        weights_path = os.environ.get(env_var, default_path)
    if not os.path.exists(weights_path):
        raise FileNotFoundError(
            f"DPT weights not found at {weights_path}; convert them once "
            "with python -m ucnerf_torch.convert_weights dpt|dpt_seg")
    if weights_path.endswith((".pt", ".pth", ".bin")):
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        params = convert_dpt_torch_state_dict(
            {k: v.numpy() for k, v in sd.items()})
    else:
        with np.load(weights_path) as data:
            params = {k: data[k] for k in data.files}
    return to_torch_params(params, dtype, device)


# MiDaS metric conversion used by the reference (run_monodepth.py:53-61)
MIDAS_SCALE = 0.000305
MIDAS_SHIFT = 0.1378


def midas_to_metric_depth(pred, scale: float = MIDAS_SCALE,
                          shift: float = MIDAS_SHIFT):
    d = scale * pred + shift
    return 1.0 / torch.clamp(d, min=1e-8)


def dpt_input_size(h: int, w: int, target: int = 384, multiple: int = 32):
    """The reference's DPT inference size: keep-aspect 'minimal' resize
    toward ``target`` with multiple-of-32 sides (``np.round``: half to
    even).  Returns (new_h, new_w)."""
    scale_h = target / h
    scale_w = target / w
    # 'minimal': scale as little as possible — fit whichever axis is closer
    if abs(1 - scale_w) < abs(1 - scale_h):
        scale_h = scale_w
    else:
        scale_w = scale_h
    new_h = int(np.round(scale_h * h / multiple) * multiple)
    new_w = int(np.round(scale_w * w / multiple) * multiple)
    return new_h, new_w


def _net_input(img01, dev, dtype, target):
    """img01 [H, W, 3] in [0, 1] -> (the net's normalized input
    [1, 3, h, w], (H, W), (h, w)): bicubic (a=-0.75) to
    ``dpt_input_size``, then (x - 0.5) / 0.5."""
    x = torch.as_tensor(np.asarray(img01, np.float32), device=dev)
    H, W = x.shape[:2]
    net_hw = dpt_input_size(H, W, target=target)
    if net_hw != (H, W):
        x = resize_bicubic(x, net_hw)
    x = ((x - 0.5) / 0.5).to(dtype)
    return x.permute(2, 0, 1)[None].contiguous(), (H, W), net_hw


def load_dpt(weights_path=None, metric: bool = True, dtype=None,
             device=None):
    """predict(img01 [H, W, 3] in [0, 1]) -> depth [H, W] f32 numpy, on
    ``device`` (the card unless told otherwise).

    The reference's protocol (``run_monodepth.py:88-114``): the frame is
    resized to ``dpt_input_size`` with the a=-0.75 bicubic, normalized
    with 0.5/0.5, run through the net, converted to metric depth (the
    reference bakes scale/shift/invert into its model) and resized back to
    the frame's size with the same bicubic.  ``dtype="bfloat16"`` runs the
    net in bf16 (the reference runs fp16 on CUDA)."""
    dev = resolve_device(device)
    params = _load_converted_params(
        weights_path, "UCNERF_DPT_WEIGHTS",
        "pretrained_weights/dpt_hybrid.npz", dtype, dev)
    in_dt = _torch_dtype(dtype)

    @torch.no_grad()
    def predict(img01):
        x, (H, W), net_hw = _net_input(img01, dev, in_dt, 384)
        pred = dpt_forward(params, x)[0]
        pred = midas_to_metric_depth(pred) if metric else pred
        if net_hw != (H, W):
            pred = resize_bicubic(pred, (H, W), h_axis=-2, w_axis=-1)
        return pred.cpu().numpy()

    return predict


def load_dpt_seg(weights_path=None, dtype=None, device=None):
    """predict(img01 [H, W, 3] in [0, 1]) -> (labels [H, W] int32 in
    [1, num_labels], logits [H, W, num_labels] f32), numpy.

    The reference's segmentation runner (``run_segmentation.py:52-107``):
    'minimal' resize toward 480 with the a=-0.75 bicubic, 0.5/0.5
    normalization, the net, the logits resized back with the same bicubic,
    argmax + 1 (ADE20K labels are 1-based)."""
    dev = resolve_device(device)
    params = _load_converted_params(
        weights_path, "UCNERF_DPT_SEG_WEIGHTS",
        "pretrained_weights/dpt_hybrid_seg.npz", dtype, dev)
    in_dt = _torch_dtype(dtype)

    @torch.no_grad()
    def predict(img01):
        x, (H, W), net_hw = _net_input(img01, dev, in_dt, 480)
        logits = dpt_seg_forward(params, x)[0].permute(1, 2, 0)
        if net_hw != (H, W):
            logits = resize_bicubic(logits, (H, W))
        labels = torch.argmax(logits, dim=-1).to(torch.int32) + 1
        return labels.cpu().numpy(), logits.cpu().numpy()

    return predict


# ------------------------------------------------------- seeded weights
def _bit_shapes() -> Iterator[Tuple[str, Tuple[int, ...]]]:
    yield BIT + "embedder.convolution.weight", (64, 3, 7, 7)
    yield BIT + "embedder.norm.weight", (64,)
    yield BIT + "embedder.norm.bias", (64,)
    c_in = 64
    for si, (depth, c_out) in enumerate(zip(BIT_DEPTHS, BIT_CHANNELS)):
        mid = c_out // 4
        for li in range(depth):
            pre = BIT + f"encoder.stages.{si}.layers.{li}."
            if li == 0:
                yield pre + "downsample.conv.weight", (c_out, c_in, 1, 1)
                yield pre + "downsample.norm.weight", (c_out,)
                yield pre + "downsample.norm.bias", (c_out,)
            convs = ((mid, c_in if li == 0 else c_out, 1), (mid, mid, 3),
                     (c_out, mid, 1))
            for i, (o, c, k) in enumerate(convs, 1):
                yield pre + f"conv{i}.weight", (o, c, k, k)
                yield pre + f"norm{i}.weight", (o,)
                yield pre + f"norm{i}.bias", (o,)
        c_in = c_out


def _bn_shapes(prefix, c):
    for name in ("weight", "bias", "running_mean", "running_var"):
        yield prefix + name, (c,)
    yield prefix + "num_batches_tracked", ()


def dpt_state_dict_shapes(task: str = "depth",
                          num_labels: int = ADE20K_LABELS):
    """Names and shapes of transformers' hybrid ``DPTForDepthEstimation``
    (``task="depth"``, 414 entries) or ``DPTForSemanticSegmentation``
    (``task="seg"``, with BN'd fusion units and the auxiliary head), in
    their state-dict order."""
    if task not in ("depth", "seg"):
        raise ValueError(f"task {task!r} is neither 'depth' nor 'seg'")
    seg = task == "seg"
    shapes = {"dpt.embeddings.cls_token": (1, 1, HIDDEN),
              "dpt.embeddings.position_embeddings": (1, 1 + 24 * 24, HIDDEN)}
    shapes.update(_bit_shapes())
    shapes["dpt.embeddings.projection.weight"] = (HIDDEN, BIT_CHANNELS[-1],
                                                  1, 1)
    shapes["dpt.embeddings.projection.bias"] = (HIDDEN,)
    for li in range(N_LAYERS):
        pre = f"dpt.encoder.layer.{li}."
        for name, (o, i) in (("attention.attention.query", (HIDDEN, HIDDEN)),
                             ("attention.attention.key", (HIDDEN, HIDDEN)),
                             ("attention.attention.value", (HIDDEN, HIDDEN)),
                             ("attention.output.dense", (HIDDEN, HIDDEN)),
                             ("intermediate.dense", (4 * HIDDEN, HIDDEN)),
                             ("output.dense", (HIDDEN, 4 * HIDDEN))):
            shapes[pre + name + ".weight"] = (o, i)
            shapes[pre + name + ".bias"] = (o,)
        for name in ("layernorm_before", "layernorm_after"):
            shapes[pre + name + ".weight"] = (HIDDEN,)
            shapes[pre + name + ".bias"] = (HIDDEN,)
    shapes["dpt.layernorm.weight"] = (HIDDEN,)
    shapes["dpt.layernorm.bias"] = (HIDDEN,)
    pre = "neck.reassemble_stage."
    for i in (2, 3):
        shapes[pre + f"layers.{i}.projection.weight"] = (HIDDEN, HIDDEN, 1, 1)
        shapes[pre + f"layers.{i}.projection.bias"] = (HIDDEN,)
    shapes[pre + "layers.3.resize.weight"] = (HIDDEN, HIDDEN, 3, 3)
    shapes[pre + "layers.3.resize.bias"] = (HIDDEN,)
    for i in (2, 3):
        shapes[pre + f"readout_projects.{i}.0.weight"] = (HIDDEN, 2 * HIDDEN)
        shapes[pre + f"readout_projects.{i}.0.bias"] = (HIDDEN,)
    for i, c in enumerate((256, 512, HIDDEN, HIDDEN)):
        shapes[f"neck.convs.{i}.weight"] = (FUSION, c, 3, 3)
    for i in range(4):
        pre = f"neck.fusion_stage.layers.{i}."
        shapes[pre + "projection.weight"] = (FUSION, FUSION, 1, 1)
        shapes[pre + "projection.bias"] = (FUSION,)
        for r in (1, 2):
            unit = pre + f"residual_layer{r}."
            for c in (1, 2):
                shapes[unit + f"convolution{c}.weight"] = (FUSION, FUSION,
                                                           3, 3)
                if not seg:
                    shapes[unit + f"convolution{c}.bias"] = (FUSION,)
            if seg:
                for c in (1, 2):
                    shapes.update(_bn_shapes(unit + f"batch_norm{c}.", FUSION))
    if not seg:
        shapes.update({"head.head.0.weight": (FUSION // 2, FUSION, 3, 3),
                       "head.head.0.bias": (FUSION // 2,),
                       "head.head.2.weight": (32, FUSION // 2, 3, 3),
                       "head.head.2.bias": (32,),
                       "head.head.4.weight": (1, 32, 1, 1),
                       "head.head.4.bias": (1,)})
        return shapes
    for head in ("head", "auxiliary_head"):
        shapes[f"{head}.head.0.weight"] = (FUSION, FUSION, 3, 3)
        shapes.update(_bn_shapes(f"{head}.head.1.", FUSION))
        shapes[f"{head}.head.4.weight"] = (num_labels, FUSION, 1, 1)
        shapes[f"{head}.head.4.bias"] = (num_labels,)
    return shapes


def _seeded_array(name: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return np.zeros(shape, np.int64)
    if leaf == "running_mean":
        return rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    if leaf == "running_var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    # zero-mean unit-variance uniform draws, scaled in place (uniform
    # float32 draws are ~3x faster than normal ones over 122 M values)
    z = rng.random(shape, dtype=np.float32)
    z -= np.float32(0.5)
    z *= np.float32(2.0 * math.sqrt(3.0))
    if leaf == "weight" and len(shape) == 1:           # a norm's scale
        z *= np.float32(0.1)
        z += np.float32(1.0)
        if name.endswith("norm3.weight"):   # a BiT bottleneck's last norm
            z *= np.float32(BIT_BRANCH_SCALE)
    elif len(shape) == 4:                              # He, fan in
        z *= np.float32(math.sqrt(2.0 / np.prod(shape[1:])))
    else:                               # linears, biases, cls, positions
        z *= np.float32(0.02)
    return z


def seeded_dpt_state_dict(seed: int = 0, task: str = "depth",
                          num_labels: int = ADE20K_LABELS,
                          shared: Optional[Dict[str, np.ndarray]] = None
                          ) -> Dict[str, np.ndarray]:
    """A state dict with transformers' names, shapes and dtypes
    (``dpt_state_dict_shapes``) and values drawn from ``seed``, in place of
    the published weights, which are not in the repository.  Each array is
    drawn from (seed, its name), so the depth and segmentation models of
    one seed share their trunk; ``shared`` hands over arrays already drawn
    for the same seed.  Draws z are uniform with mean 0 and variance 1,
    scaled to He's deviation for convolutions and to 0.02 for linears,
    biases and embeddings; norm scales are 1 + 0.1 z; BN running means
    U(-0.5, 0.5), variances U(0.5, 1.5).  The last norm of each BiT
    bottleneck is scaled by ``BIT_BRANCH_SCALE`` (timm's ResNetV2 starts it
    at zero): with unit-scale branches a random BiT is chaotic, and bf16
    round-off grows over its 16 bottlenecks to ~40% of the stage-3 map's
    max, where a trained one stays near the JAX test's 6e-2 bound."""
    shared = shared or {}
    return {k: shared[k] if k in shared and shared[k].shape == s
            else _seeded_array(k, s, seed)
            for k, s in dpt_state_dict_shapes(task, num_labels).items()}
