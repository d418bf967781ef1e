"""Weights from the JAX package into the port's modules.

``load_params_npz`` reads the JAX package's portable ``'/'``-keyed
``.npz`` params; ``state_dict_from_jax`` turns a JAX params tree (nested
dict of arrays) into the port's state dicts, whose names follow the
reference checkpoints.  BN running statistics have no counterpart: the
port's BN always uses batch statistics.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_FPN_BLOCKS = ["conv0.0", "conv0.1", "conv1.0", "conv1.1", "conv1.2",
               "conv2.0", "conv2.1", "conv2.2"]
_FPN_CONVS = [("out1", "Conv_0"), ("inner1", "Conv_1"), ("out2", "Conv_2"),
              ("inner2", "Conv_3"), ("out3", "Conv_4")]
_NERF_SINGLE = ["pts_bias_depth_fine", "pts_bias_confidence",
                "feature_linear", "confi_rgb_linear", "alpha_linear_1",
                "rgb_linear", "alpha_linear"]


def load_params_npz(path: str) -> Dict:
    """'/'-keyed .npz -> nested param tree."""
    tree: Dict = {}
    with np.load(path) as data:
        for k in data.files:
            parts = k.split("/")
            d = tree
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = data[k]
    return tree


def _linear(tree, prefix, out):
    out[prefix + ".weight"] = np.asarray(tree["Dense_0"]["kernel"]).T
    out[prefix + ".bias"] = np.asarray(tree["Dense_0"]["bias"])


def _conv(tree, prefix, spatial, out):
    """(*k, Cin, Cout) -> (Cout, Cin, *k); a transposed conv's
    (*k, Cout, Cin) -> (Cin, Cout, *k) by the same permutation."""
    k = np.asarray(tree["kernel"])
    out[prefix + ".weight"] = np.transpose(
        k, (spatial + 1, spatial) + tuple(range(spatial)))
    if "bias" in tree:
        out[prefix + ".bias"] = np.asarray(tree["bias"])


def _bn(tree, prefix, out):
    out[prefix + ".weight"] = np.asarray(tree["scale"])
    out[prefix + ".bias"] = np.asarray(tree["bias"])


def nerf_state_dict_from_jax(nerf_params) -> Dict[str, np.ndarray]:
    """JAX ``params['nerf']`` -> ``UCNeRFMLP`` state dict."""
    p = nerf_params["nerf"]
    out = {}
    for n in _NERF_SINGLE:
        _linear(p[n], "nerf." + n, out)
    i = 0
    while f"pts_linears_{i}" in p:
        _linear(p[f"pts_linears_{i}"], f"nerf.pts_linears.{i}", out)
        i += 1
    _linear(p["views_linears_0"], "nerf.views_linears.0", out)
    _linear(p["view_confi_linears_0"], "nerf.view_confi_linears.0", out)
    return out


def mvs_state_dict_from_jax(mvs_params) -> Dict[str, np.ndarray]:
    """JAX ``params['mvs']`` -> ``CascadeMVSNet`` state dict."""
    feat = mvs_params["feature"]
    out = {}
    for i, name in enumerate(_FPN_BLOCKS):
        _conv(feat[f"ConvBNReLU_{i}"]["Conv_0"], f"feature.{name}.conv", 2,
              out)
        _bn(feat[f"ConvBNReLU_{i}"]["BatchStatNorm_0"], f"feature.{name}.bn",
            out)
    for tname, jname in _FPN_CONVS:
        _conv(feat[jname], f"feature.{tname}", 2, out)
    s = 0
    while f"cost_reg_{s}" in mvs_params:
        cr = mvs_params[f"cost_reg_{s}"]
        pre = f"cost_regularization.{s}"
        for i in range(7):
            _conv(cr[f"ConvBNReLU_{i}"]["Conv_0"], f"{pre}.conv{i}.conv", 3,
                  out)
            _bn(cr[f"ConvBNReLU_{i}"]["BatchStatNorm_0"], f"{pre}.conv{i}.bn",
                out)
        for i, cname in enumerate(["conv7", "conv9", "conv11"]):
            block = cr[f"ConvTransposeBNReLU_{i}"]
            _conv(block, f"{pre}.{cname}.conv", 3, out)
            _bn(block["BatchStatNorm_0"], f"{pre}.{cname}.bn", out)
        _conv(cr["Conv_0"], f"{pre}.prob", 3, out)
        s += 1
    return out


def state_dict_from_jax(params_np) -> Dict[str, Dict[str, np.ndarray]]:
    """JAX params tree {'nerf': ..., 'mvs': ...} -> {'nerf': state dict,
    'mvs': state dict} of numpy arrays."""
    return {"nerf": nerf_state_dict_from_jax(params_np["nerf"]),
            "mvs": mvs_state_dict_from_jax(params_np["mvs"])}
