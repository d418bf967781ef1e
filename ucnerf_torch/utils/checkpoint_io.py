"""Weights between the JAX package's params trees and the port's modules.

``load_params`` gives the entry points their weights (``--seed``, then
``--ckpt``).  ``load_params_npz`` / ``save_params_npz`` read and write the
JAX package's portable ``'/'``-keyed ``.npz`` params.
``state_dict_from_jax`` turns a JAX params tree (nested dict of arrays)
into the port's state dicts, whose names follow the reference
checkpoints; ``jax_params_from_state_dict`` is its inverse.  Both are
pure transposes, so they carry gradient and Adam moment trees as well as
weights.  BN running statistics have no counterpart: the port's BN always
uses batch statistics.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ucnerf_torch.models.factory import init_params

_FPN_BLOCKS = ["conv0.0", "conv0.1", "conv1.0", "conv1.1", "conv1.2",
               "conv2.0", "conv2.1", "conv2.2"]
# (state-dict name, JAX name, has a bias)
_FPN_CONVS = [("out1", "Conv_0", False), ("inner1", "Conv_1", True),
              ("out2", "Conv_2", False), ("inner2", "Conv_3", True),
              ("out3", "Conv_4", False)]
_NERF_SINGLE = ["pts_bias_depth_fine", "pts_bias_confidence",
                "feature_linear", "confi_rgb_linear", "alpha_linear_1",
                "rgb_linear", "alpha_linear"]

# (JAX path, state-dict name, spatial dims of a kernel or None): a kernel
# with s spatial dims is (*k, Cin, Cout) in JAX and (Cout, Cin, *k) in
# torch (a transposed conv's (*k, Cout, Cin) and (Cin, Cout, *k) permute
# alike); a dense kernel is the s = 0 case; other tensors are equal.
Pair = Tuple[Tuple[str, ...], str, Optional[int]]


def _nerf_pairs(n_pts_linears: int) -> Iterator[Pair]:
    layers = ([(n, "nerf." + n) for n in _NERF_SINGLE]
              + [(f"pts_linears_{i}", f"nerf.pts_linears.{i}")
                 for i in range(n_pts_linears)]
              + [("views_linears_0", "nerf.views_linears.0"),
                 ("view_confi_linears_0", "nerf.view_confi_linears.0")])
    for jname, tname in layers:
        yield ("nerf", jname, "Dense_0", "kernel"), tname + ".weight", 0
        yield ("nerf", jname, "Dense_0", "bias"), tname + ".bias", None


def _conv_bn_pairs(jpath, tprefix, spatial, kernel_path) -> Iterator[Pair]:
    yield jpath + kernel_path, tprefix + ".conv.weight", spatial
    yield jpath + ("BatchStatNorm_0", "scale"), tprefix + ".bn.weight", None
    yield jpath + ("BatchStatNorm_0", "bias"), tprefix + ".bn.bias", None


def _mvs_pairs(n_stages: int) -> Iterator[Pair]:
    for i, name in enumerate(_FPN_BLOCKS):
        yield from _conv_bn_pairs(("feature", f"ConvBNReLU_{i}"),
                                  f"feature.{name}", 2, ("Conv_0", "kernel"))
    for tname, jname, bias in _FPN_CONVS:
        yield ("feature", jname, "kernel"), f"feature.{tname}.weight", 2
        if bias:
            yield ("feature", jname, "bias"), f"feature.{tname}.bias", None
    for s in range(n_stages):
        jp, tp = (f"cost_reg_{s}",), f"cost_regularization.{s}"
        for i in range(7):
            yield from _conv_bn_pairs(jp + (f"ConvBNReLU_{i}",),
                                      f"{tp}.conv{i}", 3, ("Conv_0", "kernel"))
        for i, cname in enumerate(["conv7", "conv9", "conv11"]):
            yield from _conv_bn_pairs(jp + (f"ConvTransposeBNReLU_{i}",),
                                      f"{tp}.{cname}", 3, ("kernel",))
        yield jp + ("Conv_0", "kernel"), f"{tp}.prob.weight", 3


def _to_torch_layout(a, spatial):
    a = np.asarray(a)
    if spatial is None:
        return a
    return np.transpose(a, (spatial + 1, spatial) + tuple(range(spatial)))


def _to_jax_layout(a, spatial):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    if spatial is None:
        return a
    return np.transpose(a, tuple(range(2, 2 + spatial)) + (1, 0))


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _pairs(name: str, n: int) -> Iterator[Pair]:
    return _nerf_pairs(n) if name == "nerf" else _mvs_pairs(n)


def _count_in_tree(name: str, tree) -> int:
    """pts_linears (nerf) or cascade stages (mvs) in a JAX subtree."""
    if name == "nerf":
        return sum(k.startswith("pts_linears_") for k in tree["nerf"])
    return sum(k.startswith("cost_reg_") for k in tree)


def _count_in_state_dict(name: str, sd) -> int:
    """pts_linears (nerf) or cascade stages (mvs) in a state dict."""
    pat = ("nerf.pts_linears.{}.weight" if name == "nerf"
           else "cost_regularization.{}.prob.weight")
    n = 0
    while pat.format(n) in sd:
        n += 1
    return n


def load_params_npz(path: str) -> Dict:
    """'/'-keyed .npz -> nested param tree."""
    tree: Dict = {}
    with np.load(path) as data:
        for k in data.files:
            _set(tree, k.split("/"), data[k])
    return tree


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_params_npz(params: Dict, path: str) -> str:
    """Nested param tree -> '/'-keyed .npz, the layout that
    ``load_params_npz`` here and in the JAX package reads."""
    np.savez(path, **_flatten(params))
    return path


def nerf_state_dict_from_jax(nerf_params) -> Dict[str, np.ndarray]:
    """JAX ``params['nerf']`` -> ``UCNeRFMLP`` state dict."""
    n = _count_in_tree("nerf", nerf_params)
    return {t: _to_torch_layout(_get(nerf_params, j), s)
            for j, t, s in _nerf_pairs(n)}


def mvs_state_dict_from_jax(mvs_params) -> Dict[str, np.ndarray]:
    """JAX ``params['mvs']`` -> ``CascadeMVSNet`` state dict."""
    n = _count_in_tree("mvs", mvs_params)
    return {t: _to_torch_layout(_get(mvs_params, j), s)
            for j, t, s in _mvs_pairs(n)}


def state_dict_from_jax(params_np) -> Dict[str, Dict[str, np.ndarray]]:
    """JAX params tree -> {'nerf': state dict, 'mvs': state dict} of numpy
    arrays, for whichever of the two subtrees the tree holds."""
    conv = {"nerf": nerf_state_dict_from_jax, "mvs": mvs_state_dict_from_jax}
    return {k: conv[k](v) for k, v in params_np.items() if k in conv}


def jax_params_from_state_dict(state_dicts) -> Dict:
    """{'nerf': state dict, 'mvs': state dict} (tensors or numpy arrays,
    either key may be absent) -> the JAX params tree of numpy arrays: the
    inverse of ``state_dict_from_jax``."""
    tree: Dict = {}
    for name, sd in state_dicts.items():
        if name not in ("nerf", "mvs"):
            raise KeyError(f"unknown state dict {name!r} (nerf, mvs)")
        n = _count_in_state_dict(name, sd)
        for j, t, s in _pairs(name, n):
            _set(tree, (name,) + j, _to_jax_layout(sd[t], s))
    return tree


def load_params(cfg, device) -> Dict[str, Dict]:
    """Weights drawn from ``--seed`` (the JAX package's init laws), with
    ``--ckpt x.npz`` (JAX params layout) replacing the subtrees it holds.
    Other checkpoint formats raise ``NotImplementedError``."""
    params = init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                         device)
    if cfg.ckpt:
        if not cfg.ckpt.endswith(".npz"):
            raise NotImplementedError(
                f"ucnerf_torch loads '/'-keyed .npz params only; reference "
                f".tar/.ckpt/.pth checkpoints and orbax checkpoints "
                f"(resume) are not ported yet (--ckpt {cfg.ckpt})")
        params.update(state_dict_from_jax(load_params_npz(cfg.ckpt)))
    return params
