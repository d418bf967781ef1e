"""Weight conversion: the port of ``convert_weights.py``.

    python -m ucnerf_torch.convert_weights ucnerf    pretrained_weights/ucnerf.tar    out.npz
    python -m ucnerf_torch.convert_weights casmvsnet pretrained_weights/casmvsnet.ckpt out.npz
    python -m ucnerf_torch.convert_weights lpips     <lpips_alex_state.pth>  pretrained_weights/lpips_alex.npz
    python -m ucnerf_torch.convert_weights dpt       <dpt_hybrid_state.bin|transformers dir>  weights/dpt_hybrid.npz
    python -m ucnerf_torch.convert_weights dpt_seg   <dpt_hybrid_ade20k_state.bin|dir>        weights/dpt_hybrid_seg.npz

Each output file equals the JAX package's ``convert_weights.py`` output for
the same input, so either package reads it:
- ``ucnerf`` / ``casmvsnet``: the reference's training checkpoint or the
  published CasMVSNet weights -> the '/'-keyed params npz of ``--ckpt``
  (``utils/checkpoint_io.py::convert_reference_checkpoint``); a
  ``casmvsnet`` file without a cascade is refused.
- ``lpips``: the state dict of ``lpips.LPIPS(net='alex')`` -> the npz that
  ``eval/lpips.py::load_lpips`` reads from
  ``pretrained_weights/lpips_alex.npz`` or ``$UCNERF_LPIPS_WEIGHTS``.
- ``dpt`` / ``dpt_seg``: transformers' hybrid ``DPTForDepthEstimation`` /
  ``DPTForSemanticSegmentation`` state dict, a torch file or a
  ``from_pretrained`` directory -> the npz that ``python -m
  ucnerf_torch.preprocess dpt|seg`` reads (``--weights``,
  ``$UCNERF_DPT_WEIGHTS`` / ``$UCNERF_DPT_SEG_WEIGHTS``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def _load_torch_state(path: str):
    if os.path.isdir(path):  # transformers from_pretrained directory
        for name in ("pytorch_model.bin", "model.pth", "model.bin"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                path = p
                break
        else:
            raise FileNotFoundError(
                f"{path}: no pytorch_model.bin/model.pth inside")
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):      # a whole nn.Module was saved
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
            for k, v in obj.items()}


def convert(kind: str, src: str, dst: str) -> str:
    if kind in ("ucnerf", "casmvsnet"):
        from ucnerf_torch.utils import checkpoint_io
        params = checkpoint_io.convert_reference_checkpoint(src)
        if kind == "casmvsnet" and "mvs" not in params:
            raise ValueError(f"{src} is not a casmvsnet checkpoint")
        return checkpoint_io.save_params_npz(params, dst)

    if kind == "lpips":
        from ucnerf_torch.eval.lpips import convert_lpips_torch
        return convert_lpips_torch(_load_torch_state(src), dst)

    if kind in ("dpt", "dpt_seg"):
        from ucnerf_torch.models.dpt import convert_dpt_torch_state_dict
        params = convert_dpt_torch_state_dict(_load_torch_state(src))
        np.savez(dst, **params)
        return dst

    raise ValueError(f"unknown kind {kind!r}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        "python -m ucnerf_torch.convert_weights",
        description="Convert torch weight artifacts to the npz files both "
        "packages read.")
    parser.add_argument("kind",
                        choices=["ucnerf", "casmvsnet", "lpips", "dpt",
                                 "dpt_seg"])
    parser.add_argument("src", help="torch .tar/.ckpt/.pth/.bin file "
                        "(or a transformers directory for dpt/dpt_seg)")
    parser.add_argument("dst", help="output .npz path")
    args = parser.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.dst)), exist_ok=True)
    out = convert(args.kind, args.src, args.dst)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
