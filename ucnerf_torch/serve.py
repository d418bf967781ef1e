"""Pose -> frame render server of the port, batch mode.

Holds one scene's source views, weights and cached FeatureNet features on
the device (``render/serving.py``) and renders novel views on demand; on
the card the NeRF MLP runs as the hand-written kernel
(``kernels/fused_mlp.py``).

    python -m ucnerf_torch.serve --requests reqs.jsonl \
        --dataset_name synthetic --img_wh 320 256 --view_num 7
    # each line: {"c2w": [[...4x4...]], "out": "frame_001.npz"}

Output lines are JSON: one ``{"out", "ms"}`` per frame, ``{"error",
"line"}`` for a malformed request (the batch goes on), and a final
``{"frames", "wall_ms", "ms_per_frame"}``.  Frames are ``npz`` (rgb f32,
depth f32, confidence f32).  ``--ckpt x.npz`` loads the JAX package's
portable params; without it the weights are drawn from ``--seed``.
``--device cpu`` runs on the CPU; the default is the card.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

import numpy as np
import torch

from ucnerf_torch.config import parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.kernels.fused_mlp import FusedNeRFMLP
from ucnerf_torch.models.factory import create_models, init_params
from ucnerf_torch.render.serving import ServingRenderer
from ucnerf_torch.utils import checkpoint_io
from ucnerf_torch.utils.platform import resolve_device


def load_params(cfg, device):
    """``--ckpt x.npz`` (JAX params) or fresh weights from ``--seed``."""
    if cfg.ckpt:
        if not cfg.ckpt.endswith(".npz"):
            raise ValueError("ucnerf_torch loads '/'-keyed .npz params only "
                             f"(got --ckpt {cfg.ckpt})")
        return checkpoint_io.state_dict_from_jax(
            checkpoint_io.load_params_npz(cfg.ckpt))
    return init_params(cfg, torch.Generator().manual_seed(cfg.seed), device)


def build_renderer(cfg, scene_idx: int = 0, device=None):
    """Dataset + models + weights -> (ServingRenderer, metadata)."""
    dev = resolve_device(device)
    ds = build_dataset(cfg, "val")
    W, H = ds.img_wh
    nerf, mvs = create_models(cfg, dev, load_params(cfg, dev))
    mlp = FusedNeRFMLP(nerf)
    sample = ds[scene_idx]
    scan = ds.metas[scene_idx][0]
    renderer = ServingRenderer(cfg, mlp, mvs, sample, (H, W),
                               ds.scene[scan]["intrinsic"], dev)
    meta = {"scan": str(scan), "img_wh": [W, H], "view_num": cfg.view_num,
            "N_samples": cfg.N_samples, "chunk": cfg.chunk,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "example_c2w": np.asarray(sample["c2ws"][0]).tolist()}
    return renderer, meta


def encode_frame(rgb, depth, conf, fmt: str) -> tuple:
    """(payload bytes, content-type) for a rendered frame (npz only)."""
    if fmt != "npz":
        raise ValueError(f"format {fmt!r} is not served by ucnerf_torch yet "
                         "(npz only)")
    buf = io.BytesIO()
    np.savez(buf, rgb=rgb, depth=depth, confidence=conf)
    return buf.getvalue(), "application/octet-stream"


def validate_request(req: dict) -> tuple:
    """Request dict -> (c2w [4,4] f32, fmt).  Raises ValueError on a
    malformed request."""
    c2w = np.asarray(req.get("c2w", None), dtype=np.float32)
    if c2w.shape != (4, 4):
        raise ValueError(f"'c2w' must be a 4x4 matrix, got {c2w.shape}")
    if not np.isfinite(c2w).all():
        raise ValueError("'c2w' contains non-finite values")
    fmt = req.get("format", "npz")
    if fmt == "png":
        raise ValueError("png output is not served by ucnerf_torch yet; "
                         "ask for npz")
    if fmt != "npz":
        raise ValueError(f"unknown format {fmt!r} (npz)")
    return c2w, fmt


def handle_render(renderer: ServingRenderer, req: dict) -> tuple:
    """Validate one request dict and render it -> (payload, content_type)."""
    c2w, fmt = validate_request(req)
    return encode_frame(*renderer.render_np(c2w), fmt)


def run_batch(renderer, lines, pipeline: bool = True) -> int:
    """JSON-lines mode: render each request to its 'out' path.

    With ``pipeline`` (file input) frame i+1 is enqueued on the device
    before frame i is fetched, so the fetch and file write of frame i
    overlap the device work of frame i+1."""
    n = 0
    pending = None  # ((rgb, depth, conf) device tensors, out path, fmt, t0)

    def flush(item):
        frame, out, fmt, t0 = item
        payload, _ = encode_frame(*(t.cpu().numpy() for t in frame), fmt)
        with open(out, "wb") as fh:
            fh.write(payload)
        print(json.dumps({"out": out,
                          "ms": round((time.perf_counter() - t0) * 1e3, 1)}))

    t_all = time.perf_counter()
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if "out" not in req:
                raise ValueError("request missing 'out' path")
            out = req["out"]
            fmt = req.get("format",
                          "png" if str(out).endswith(".png") else "npz")
            c2w, fmt = validate_request(dict(req, format=fmt))
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            # a malformed line must not kill the remaining batch
            print(json.dumps({"error": str(e), "line": line[:200]}))
            continue
        t0 = time.perf_counter()
        frame = renderer.render(c2w)
        if pending is not None:
            flush(pending)
        pending = (frame, out, fmt, t0)
        if not pipeline:
            flush(pending)
            pending = None
        n += 1
    if pending is not None:
        flush(pending)
    if n:
        wall = time.perf_counter() - t_all
        print(json.dumps({"frames": n, "wall_ms": round(wall * 1e3, 1),
                          "ms_per_frame": round(wall * 1e3 / n, 1)}))
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--requests", required=True,
                        help="JSON-lines request file, '-' = stdin")
    parser.add_argument("--scene_idx", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    ns, rest = parser.parse_known_args(argv)
    cfg = parse_config(rest)

    renderer, meta = build_renderer(cfg, ns.scene_idx, ns.device)
    t0 = time.perf_counter()
    renderer.render_np(np.asarray(renderer.sample["c2ws"][0]))
    print(f"ucnerf_torch.serve: warmed up in {time.perf_counter() - t0:.1f}s;"
          f" scene {meta['scan']} at {meta['img_wh']} on {meta['device']}")
    if ns.requests == "-":
        n = run_batch(renderer, sys.stdin, pipeline=False)
    else:
        with open(ns.requests) as fh:
            n = run_batch(renderer, fh)
    print(f"ucnerf_torch.serve: rendered {n} request(s)")
    return n


if __name__ == "__main__":
    main()
