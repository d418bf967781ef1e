"""Offline preprocessing: the port of ``preprocess.py``.

    python -m ucnerf_torch.preprocess colmap <scene_dir> [--match sequential_matcher]
    python -m ucnerf_torch.preprocess dpt <scene_dir> [--weights <path>] [--bf16]
    python -m ucnerf_torch.preprocess seg <scene_dir> [--weights <path>] [--bf16]

``colmap``: SfM through the external COLMAP binary -> ``sparse/0`` and
``poses_bounds.npy`` (``data/colmap_wrapper.py::imgs2poses``; a scene that
already holds ``sparse/0/images.bin`` only gets its poses).  ``dpt``: the
DPT-Hybrid depth prior -> ``dpt/<stem>.npz{pred}`` per frame of
``images/``, at the frame's size.  ``seg``: ADE20K segmentation ->
``seg/<stem>.npz{labels}`` and the palette-blended ``seg/<stem>.png``.
The files are those the JAX package's script writes, named as it names
them: the SCARED and Hamlyn loaders find ``dpt/<stem>.npz`` beside
``.jpeg`` / ``.jpg`` frames (they derive the name by replacing the frame's
extension with ``npz``).

Frames are read with ``data/image_io.py::read_frame`` (JPEG or PNG, no PIL)
and scaled by 1/255.  The weights are the npz of ``python -m
ucnerf_torch.convert_weights dpt|dpt_seg`` (or a torch state dict), else
``$UCNERF_DPT_WEIGHTS`` / ``$UCNERF_DPT_SEG_WEIGHTS``, else
``pretrained_weights/dpt_hybrid{,_seg}.npz``.  ``dpt`` and ``seg`` run on the
card unless ``--device cpu`` is given; ``--bf16`` runs the net in bf16.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np


def _frames(scene_dir: str):
    return sorted(glob.glob(os.path.join(scene_dir, "images/*")))


def _read01(path: str) -> np.ndarray:
    from ucnerf_torch.data.image_io import read_frame
    return np.asarray(read_frame(path), np.float32)[..., :3] / 255.0


def cmd_colmap(ns):
    from ucnerf_torch.data import colmap_wrapper
    colmap_wrapper.imgs2poses(ns.scene_dir, ns.match)
    out = os.path.join(ns.scene_dir, "poses_bounds.npy")
    print(f"wrote {out}")
    return {"poses_bounds": out}


def cmd_dpt(ns):
    from ucnerf_torch.models import dpt
    from ucnerf_torch.utils.platform import resolve_device
    dev = resolve_device(ns.device)
    t0 = time.perf_counter()
    predict = dpt.load_dpt(ns.weights, dtype="bfloat16" if ns.bf16 else None,
                           device=dev)
    load_s = time.perf_counter() - t0
    out_dir = os.path.join(ns.scene_dir, "dpt")
    os.makedirs(out_dir, exist_ok=True)
    ms = []
    for p in _frames(ns.scene_dir):
        t0 = time.perf_counter()
        pred = predict(_read01(p))
        name = os.path.splitext(os.path.basename(p))[0]
        np.savez(os.path.join(out_dir, name + ".npz"), pred=pred)
        ms.append((time.perf_counter() - t0) * 1e3)
        print(f"dpt: {name} ({pred.shape})")
    return {"frames": len(ms), "load_s": load_s, "ms_per_frame": ms}


def cmd_seg(ns):
    from ucnerf_torch.models import dpt
    from ucnerf_torch.utils.platform import resolve_device
    from ucnerf_torch.utils.png import write_png
    from ucnerf_torch.utils.viz import blend_segmentation
    dev = resolve_device(ns.device)
    t0 = time.perf_counter()
    predict = dpt.load_dpt_seg(ns.weights,
                               dtype="bfloat16" if ns.bf16 else None,
                               device=dev)
    load_s = time.perf_counter() - t0
    out_dir = os.path.join(ns.scene_dir, "seg")
    os.makedirs(out_dir, exist_ok=True)
    ms = []
    for p in _frames(ns.scene_dir):
        t0 = time.perf_counter()
        img = _read01(p)
        labels, _ = predict(img)
        name = os.path.splitext(os.path.basename(p))[0]
        np.savez(os.path.join(out_dir, name + ".npz"), labels=labels)
        write_png(os.path.join(out_dir, name + ".png"),
                  blend_segmentation(img, labels))
        ms.append((time.perf_counter() - t0) * 1e3)
        print(f"seg: {name} ({labels.shape}, "
              f"{len(np.unique(labels))} classes)")
    return {"frames": len(ms), "load_s": load_s, "ms_per_frame": ms}


def main(argv=None) -> dict:
    """Runs one subcommand; returns what it did (for ``dpt`` and ``seg``:
    frames, the weights' load seconds and each frame's ms)."""
    parser = argparse.ArgumentParser("python -m ucnerf_torch.preprocess")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("colmap")
    pc.add_argument("scene_dir")
    pc.add_argument("--match", default="exhaustive_matcher",
                    choices=["exhaustive_matcher", "sequential_matcher"])
    pc.set_defaults(fn=cmd_colmap)
    for name, fn in (("dpt", cmd_dpt), ("seg", cmd_seg)):
        ps = sub.add_parser(name)
        ps.add_argument("scene_dir")
        ps.add_argument("--weights", default=None)
        ps.add_argument("--bf16", action="store_true",
                        help="run the net in bf16 (the reference runs "
                        "fp16 on CUDA)")
        ps.add_argument("--device", default=None,
                        help="torch device (default: the card)")
        ps.set_defaults(fn=fn)
    ns = parser.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    main()
