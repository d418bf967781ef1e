"""Weights between the JAX package's params trees and the port's modules,
and the port's checkpoints.

``load_params`` gives the entry points their weights (``--seed``, then
``--ckpt`` of any form).  ``save_checkpoint`` / ``load_checkpoint`` write
and restore the trainer's state (weights, Adam's moments, step) for exact
resume; they stand in for the JAX package's orbax checkpoints.
``load_params_npz`` / ``save_params_npz`` read and write the JAX package's
portable ``'/'``-keyed ``.npz`` params; ``convert_reference_checkpoint``
turns a reference checkpoint into that tree.
``state_dict_from_jax`` turns a JAX params tree (nested dict of arrays)
into the port's state dicts, whose names follow the reference
checkpoints; ``jax_params_from_state_dict`` is its inverse.  Both are
pure transposes, so they carry gradient and Adam moment trees as well as
weights; ``--encode_a``'s appearance table is ``appearance`` in both, as
it is.  BN running statistics have no counterpart: the port's BN always
uses batch statistics.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
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
    arrays, for whichever of the two subtrees the tree holds, and its
    ``appearance`` table as it is."""
    conv = {"nerf": nerf_state_dict_from_jax, "mvs": mvs_state_dict_from_jax,
            "appearance": np.asarray}
    return {k: conv[k](v) for k, v in params_np.items() if k in conv}


def jax_params_from_state_dict(state_dicts) -> Dict:
    """{'nerf': state dict, 'mvs': state dict, 'appearance': table}
    (tensors or numpy arrays, any key may be absent) -> the JAX params
    tree of numpy arrays: the inverse of ``state_dict_from_jax``."""
    tree: Dict = {}
    for name, sd in state_dicts.items():
        if name == "appearance":
            tree[name] = _to_jax_layout(sd, None)
            continue
        if name not in ("nerf", "mvs"):
            raise KeyError(f"unknown state dict {name!r} (nerf, mvs, "
                           f"appearance)")
        n = _count_in_state_dict(name, sd)
        for j, t, s in _pairs(name, n):
            _set(tree, (name,) + j, _to_jax_layout(sd[t], s))
    return tree


# ------------------------------------------------------ native checkpoints
PARAMS_FILE = "params.npz"
STATE_FILE = "train_state.pt"
# what marks a directory as an orbax checkpoint (the JAX package's format)
ORBAX_FILES = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def params_tree(nerf, mvs, appearance=None) -> Dict:
    """The modules' weights (and ``--encode_a``'s table, when given) as the
    JAX params tree of numpy arrays."""
    sds = {"nerf": nerf.state_dict(), "mvs": mvs.state_dict()}
    if appearance is not None:
        sds["appearance"] = appearance
    return jax_params_from_state_dict(sds)


def checkpoint_params(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """A native checkpoint's weights as {'nerf', 'mvs'} state dicts (and
    ``'appearance'`` when it holds the table)."""
    return state_dict_from_jax(load_params_npz(os.path.join(path,
                                                            PARAMS_FILE)))


def _step_dirs(ckpt_dir: str):
    return sorted(d for d in os.listdir(ckpt_dir)
                  if re.fullmatch(r"step_\d{8}", d)
                  and os.path.isdir(os.path.join(ckpt_dir, d)))


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 0) -> str:
    """Write ``<ckpt_dir>/step_{step:08d}/``: ``params.npz`` (the JAX
    package's '/'-keyed params layout, which ``--ckpt x.npz`` of both
    packages reads) and ``train_state.pt`` (step, the optimizer's state
    dict with Adam's moments, and the objective).

    The directory is written under a temporary name and renamed into
    place, so a save killed midway leaves no half checkpoint for a resume
    to find; re-saving a step replaces it.  ``keep > 0`` then prunes the
    oldest ``step_*`` directories so that at most ``keep`` remain (0 keeps
    all, as the reference does with its 5000-step dumps)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    path = os.path.join(ckpt_dir, name)
    tmp = tempfile.mkdtemp(prefix=f".{name}.", dir=ckpt_dir)
    try:
        save_params_npz(params_tree(state.nerf, state.mvs, state.appearance),
                        os.path.join(tmp, PARAMS_FILE))
        torch.save({"step": int(step),
                    "optimizer": state.optimizer.state_dict(),
                    "objective": state.objective},
                   os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):
            old = tempfile.mkdtemp(prefix=f".{name}.old.", dir=ckpt_dir)
            os.replace(path, os.path.join(old, name))
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    if keep > 0:
        old = [d for d in _step_dirs(ckpt_dir) if d != name]
        for d in old[:max(0, len(old) - (keep - 1))]:
            shutil.rmtree(os.path.join(ckpt_dir, d))
    return path


def load_checkpoint(path: str, state):
    """Restore a native checkpoint into ``state`` in place: the weights,
    the optimizer's state (Adam's moments) and the step.  A checkpoint of
    another objective (``--mvs_only`` | full | ``--finetune``) raises: a
    phase hand-off takes ``--ckpt_params_only``."""
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    if saved["objective"] != state.objective:
        raise ValueError(
            f"{path} was saved by a {saved['objective']!r} run and this run "
            f"trains {state.objective!r}: a full resume continues the same "
            f"objective; to seed this phase from its weights, pass "
            f"--ckpt_params_only")
    sd = checkpoint_params(path)
    for module, key in ((state.nerf, "nerf"), (state.mvs, "mvs")):
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in sd[key].items()}, strict=True)
    if (state.appearance is not None) != ("appearance" in sd):
        raise ValueError(f"{path}: a full resume keeps --encode_a as the "
                         f"saved run had it")
    if state.appearance is not None:
        with torch.no_grad():
            state.appearance.copy_(torch.from_numpy(sd["appearance"]))
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


# ------------------------------------------------- reference checkpoints
# layers of the reference MLP that its forward never uses
_REFERENCE_UNUSED = ("nerf.feature_linear_1", "nerf.confi_linear",
                     "nerf.pts_bias_confidence_1")
_BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _reference_state_dict(sd) -> Dict[str, torch.Tensor]:
    """A reference state dict less its unused layers and BN running
    statistics: the port's module names are the reference's."""
    return {k: v for k, v in sd.items()
            if k.rsplit(".", 1)[0] not in _REFERENCE_UNUSED
            and not k.endswith(_BN_STATS)}


def load_reference_checkpoint(path: str) -> Dict[str, Dict]:
    """A reference torch checkpoint -> {'nerf': state dict, 'mvs': state
    dict} for the subtrees it holds (``network/models.py:240-266``):
    ``ucnerf.tar`` holds ``network_fn_state_dict`` and
    ``network_mvs_state_dict``; the published ``casmvsnet.ckpt`` holds
    ``{'model': ...}`` and seeds the cascade only."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if "network_fn_state_dict" in obj:
        return {"nerf": _reference_state_dict(obj["network_fn_state_dict"]),
                "mvs": _reference_state_dict(obj["network_mvs_state_dict"])}
    if "model" in obj:
        return {"mvs": _reference_state_dict(obj["model"])}
    raise ValueError(
        f"{path}: unrecognized checkpoint format (expected ucnerf.tar "
        "keys network_fn_state_dict/network_mvs_state_dict, or "
        "casmvsnet.ckpt key 'model'); found " + ", ".join(sorted(obj)[:8]))


def convert_reference_checkpoint(path: str) -> Dict:
    """A reference ``ucnerf.tar`` or ``casmvsnet.ckpt`` -> the JAX params
    tree of numpy arrays, as ``convert_reference_checkpoint`` of the JAX
    package gives it (``save_params_npz`` writes it as the '/'-keyed npz
    both packages read with ``--ckpt``)."""
    return jax_params_from_state_dict(load_reference_checkpoint(path))


def load_params(cfg, device) -> Dict[str, Dict]:
    """The weights of ``--seed`` and ``--ckpt`` (``load_eval_params`` of
    the JAX package): drawn from ``--seed`` with the JAX package's init
    laws, then replaced by the subtrees the checkpoint holds (a reference
    checkpoint holds no appearance table, so ``--encode_a``'s keeps its
    drawn value):
    - ``x.npz``: the JAX package's '/'-keyed params layout;
    - a native checkpoint directory (``save_checkpoint``): its params;
    - a JAX orbax checkpoint directory raises, naming
      ``scripts/export_params_npz.py``, which exports it to an ``.npz``;
    - a reference ``.tar/.ckpt/.pth``: ``load_reference_checkpoint`` (a
      ``casmvsnet.ckpt`` replaces the cascade only)."""
    params = init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                         device)
    if not cfg.ckpt:
        return params
    if cfg.ckpt.endswith((".tar", ".ckpt", ".pth")):
        params.update(load_reference_checkpoint(cfg.ckpt))
    elif cfg.ckpt.endswith(".npz"):
        params.update(state_dict_from_jax(load_params_npz(cfg.ckpt)))
    elif os.path.isfile(os.path.join(cfg.ckpt, PARAMS_FILE)):
        params.update(checkpoint_params(cfg.ckpt))
    elif any(os.path.exists(os.path.join(cfg.ckpt, f)) for f in ORBAX_FILES):
        raise ValueError(
            f"--ckpt {cfg.ckpt} is an orbax checkpoint of the JAX package, "
            f"which ucnerf_torch cannot read.  Export its "
            f"weights where JAX runs, with the run's own flags:\n"
            f"  python scripts/export_params_npz.py {cfg.ckpt} params.npz "
            f"<flags>\nand pass --ckpt params.npz")
    else:
        raise FileNotFoundError(
            f"--ckpt {cfg.ckpt}: neither a .npz / .tar / .ckpt / .pth file "
            f"nor a checkpoint directory holding {PARAMS_FILE}")
    return params
