"""Smoke test of ucnerf_torch on one CUDA card: builds the port's kernels,
holds each against its plain PyTorch version, serves novel views at the
SCARED operating point through ``python -m ucnerf_torch.serve``'s batch
and HTTP modes, renders a trajectory through ``python -m
ucnerf_torch.render_path``, and trains at the SCARED train point through
``python -m ucnerf_torch.train``'s entry point: a run stopped at a
checkpoint, its resume against an uninterrupted run (both with
``--deterministic``), ``--eval`` of the checkpoint over the whole val split
with ``--val_panels all``, the device scene store against host loading,
and an overfit of one sample.  Phase ``scared`` fabricates a
SCARED-layout scan at 1280x1024 with the port's own writers, loads it cold
and warm through the scene cache, trains 12 steps on it through ``python
-m ucnerf_torch.train --dataset_name scared``, evaluates the checkpoint
over its val split on K1, serves one request from it, and decodes the
committed JPEG fixtures to their recorded digests.  Phase ``preprocess``
converts seeded DPT-Hybrid and LPIPS weights through ``python -m
ucnerf_torch.convert_weights``, runs ``python -m ucnerf_torch.preprocess
dpt`` over that scan in f32 and bf16 and ``seg`` on two of its frames,
holds the card's DPT against its CPU forward, and evaluates the scan's
checkpoint with the converted LPIPS weights.  Which parts of a train
step vary run to run on the card's default kernels is measured on demand
by ``scripts/determinism_probe.py``, the DPT forward's backend settings
by ``scripts/dpt_probe.py``.

    python3 chip_smoke.py

Phases (one line each): device, build, k1 (K1 vs plain), serving, http,
render_path, resume, panels, store_vs_host, train, scared, preprocess.
Any failed check raises, so the script exits non-zero and prints no
result.  Before the last line it prints the card's ``nvidia-smi`` name and
power limit and one JSON line with every kernel of the main path (K1's
launches summed over serving, HTTP, render_path, the eval, phase scared's
eval and request, and phase preprocess's eval); the last line is
``{"ok": true, "device": {...}}``.  Frames, panels, the trainer runs'
stdout and directories (their checkpoints are deleted once checked),
profiles and a JSON record go to ``chiprun_out/chip_smoke/`` beside this
file.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"
PEAK_BF16 = 989e12          # H100 SXM dense tensor-core FLOP/s
PEAK_F32 = 67e12            # H100 SXM FP32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s
SERVE_ARGS = ["--dataset_name", "synthetic", "--img_wh", "320", "256",
              "--view_num", "7"]
N_REQUESTS = 3
N_HTTP = 3                 # npz requests of the http phase on default kernels
# the http phase's npz frames against the batch-mode frame of the same
# pose, mean abs of rgb, depth and confidence: on the card's default
# kernels the cascade is not run-to-run deterministic (the first chip run
# of this phase read rgb max abs 1.6e-2, depth 2.4e-2, confidence 2.3e-3)
HTTP_TOL = 1e-3
PATH_FRAMES = 12           # frames of the render_path phase
# panel 0's 8-bit rendered tile against view 0 rendered again on K1:
# (mean abs in levels, share of pixels more than one level off).  On the
# card's default kernels two renders of one pose differ by rgb mean abs
# 1.3e-5 (0.003 levels), max 2.7e-2 (PERF.md §6), so a few pixels flip
# at rounding edges; another view's frame is many levels away
PANEL_TOL = (0.05, 1e-2)
# the train point of bench.py: 2000 rays (50 patches of 6x6 + 200 uniform)
# + 1024 sparse-depth rays, 90 samples per ray, cascade depths 48/32/8
TRAIN_POINT = ["--batch_size", "2000", "--patch_size", "6", "--patch_num",
               "50", "--n_depth_rays", "1024", "--N_samples", "90",
               "--num_epochs", "30", "--chunk", "1024"]
TRAIN_ARGS = [*SERVE_ARGS, *TRAIN_POINT]
TRAIN_STEPS = 12           # the run that stops at a checkpoint
RESUME_STEPS = 16          # its resume, and the uninterrupted run
OVERFIT_STEPS = 30
DET_STEPS = 8              # the overfit step again on deterministic kernels
# phase scared: a SCARED-layout scan fabricated here at the native
# 1280x1024 (frames as PNG: the card's machine has no JPEG encoder),
# trained and evaluated at the same train point through --dataset_name
# scared; it lives beside OUT_DIR while the phase runs and is deleted
SCAN_DIR = OUT_DIR.parent / "scared_scan"
SCAN_FRAMES = 16
SCAN_WH = (1280, 1024)
SCAN_DPT_WH = (480, 384)     # the DPT prior's size (not 320x256)
SCAN_POINTS = 4000
SCARED_ARGS = ["--dataset_name", "scared", "--datadir", str(SCAN_DIR),
               "--view_num", "7"]
SCAN_ARGS = [*SCARED_ARGS, *TRAIN_POINT]      # the scan at the train point
FIXTURES = ROOT / "tests" / "data"
# phase preprocess: seeded weights under their published names, converted
# by python -m ucnerf_torch.convert_weights, then python -m
# ucnerf_torch.preprocess over phase scared's scan; deleted at the end
PRE_DIR = OUT_DIR.parent / "preprocess"
SEG_FRAMES = 2
# the card's f32 DPT (TF32 off) against the port's own CPU forward of the
# same weights and input, rel-to-max of the trunk and of the inverse depth
DPT_CPU_TOL = 1e-3
# the card's bf16 trunk against its f32 trunk: the JAX package's bound on
# its bf16 trunk (tests/test_dpt.py:176)
DPT_BF16_TOL = 6e-2
# the CPU parity tests' small shape (tests/test_torch_train.py)
SMALL_ARGS = ["--dataset_name", "synthetic", "--view_num", "4", "--N_samples",
              "9", "--batch_size", "80", "--patch_size", "4", "--patch_num",
              "4", "--n_depth_rays", "32", "--chunk", "256", "--num_epochs",
              "4", "--lrate", "5e-4", "--ndepths", "8", "8", "8",
              "--nerf_dtype", "float32"]


def check(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def log(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mlp_inputs(n_rays: int, n_samples: int, feat_dim: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, (n_rays, n_samples, 3))
    dirs = rng.standard_normal((n_rays, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    feats = rng.standard_normal((n_rays, n_samples, feat_dim))
    feats[..., -1] = rng.uniform(0.0, 1.0, (n_rays, n_samples))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
            for a in (pts, dirs, feats)]


def mlp_work(cfg, n_rays: int, n_samples: int, weight_bytes: int):
    """(FLOPs, bytes) that one MLP call must do / move at these shapes."""
    v1 = cfg.view_num - 1
    W = cfg.netwidth
    macs = ((24 + 4 * v1) * W + 8 * v1 * W      # depth_bias, feats_bias
            + 63 * W + 4 * W * W + (63 + W) * W  # trunk (skip at layer 5)
            + W * 4                              # base rgb + alpha heads
            + W * W                              # feature_linear
            + 2 * (W + 27) * (W // 2)            # views / view_confi
            + (W // 2) * 4)                      # adapt rgb + alpha heads
    P = n_rays * n_samples
    nbytes = (P * 3 + n_rays * 3 + P * cfg.feat_dim + P * 4) * 4 + weight_bytes
    return 2 * macs * P, nbytes, macs


# device-time groups by kernel name, first match wins (implicit-GEMM
# convolutions before plain GEMMs)
KERNEL_KINDS = (
    ("K1", ("fused_mlp",)),
    ("cudnn_conv_bn", ("cudnn", "wgrad", "dgrad", "convolve", "fft2d",
                       "implicit_gemm", "bn_")),
    ("gemm", ("gemm",)),
    ("index_sort", ("index", "Radix", "gather", "scatter")),
)


def kernel_kind(name: str) -> str:
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "elementwise_other"


def profile_frame(fn, top: int = 12, name: str = "profile.txt") -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), the
    device's busy share of the wall time, device time by kernel kind
    (``KERNEL_KINDS``), and the table in full under OUT_DIR/``name``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side annotations (Optimizer.step#Adam.step) span kernels that
    # are listed themselves, so they are not device time of their own
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    dev_us = {e.key: (e.self_device_time_total, e.count) for e in events}
    busy_ms = sum(us for us, _ in dev_us.values()) / 1e3
    kernels = sorted(dev_us.items(), key=lambda kv: -kv[1][0])
    (OUT_DIR / name).write_text("".join(
        f"{us / 1e3:10.3f} ms {n:6d}x  {k}\n" for k, (us, n) in kernels))
    by_kind = {}
    for k, (us, _) in kernels:
        by_kind[kernel_kind(k)] = by_kind.get(kernel_kind(k), 0.0) + us / 1e3
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                by_kind_ms=by_kind,
                n_device_kernels=sum(e.count for e in events),
                top_kernels_ms={k[:80]: us / 1e3
                                for k, (us, _) in kernels[:top]})


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    import scipy
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        numpy=np.__version__, scipy=scipy.__version__,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def ptxas_by_kernel(text: str) -> dict:
    """``-Xptxas -v`` output -> {entry: {registers, stack_bytes,
    spill_stores, spill_loads, static_smem_bytes}}, entries named by the
    ``fused_mlp_*_kernel`` part of the mangled name."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            k = re.search(r"(fused_mlp_[a-z0-9]+_kernel)", m.group(1))
            cur = out.setdefault(k.group(1) if k else m.group(1),
                                 {"static_smem_bytes": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            cur["static_smem_bytes"] = int(m.group(1))
    return out


def phase_build():
    """Every native source of the path at once: K1 with nvcc, the JPEG
    decoder with the host compiler."""
    from concurrent.futures import ThreadPoolExecutor
    from ucnerf_torch.kernels import build
    t0 = time.perf_counter()
    names = ("fused_mlp", "jpeg_decode")
    with ThreadPoolExecutor(len(names)) as pool:
        res = dict(zip(names, pool.map(build.build, names)))
    log("build", kernel="fused_mlp", seconds=time.perf_counter() - t0,
        nvcc_seconds=res["fused_mlp"]["seconds"],
        cxx_seconds=res["jpeg_decode"]["seconds"],
        ptxas=ptxas_by_kernel(res["fused_mlp"]["ptxas"]))


def phase_k1(cfg, dev):
    """K1 against its plain version at the serving shape and a ragged one."""
    from ucnerf_torch.kernels.fused_mlp import (FusedNeRFMLP, fused_nerf_mlp,
                                                kernel_attrs)
    from ucnerf_torch.models.factory import create_models, init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    nerf = {dt: create_models(cfg.replace(nerf_dtype=dt), dev, params)[0]
            for dt in ("float32", "bfloat16")}
    fused = {dt: FusedNeRFMLP(m) for dt, m in nerf.items()}
    S = cfg.N_samples
    res = {}
    with torch.no_grad():
        for n_rays, key in ((cfg.chunk, "serving"), (37, "ragged")):
            pts, dirs, feats = mlp_inputs(n_rays, S, cfg.feat_dim, 1, dev)
            truth = nerf["float32"](pts, dirs, feats)
            plain_bf16 = nerf["bfloat16"](pts, dirs, feats)
            k32 = fused["float32"](pts, dirs, feats)
            k16 = fused["bfloat16"](pts, dirs, feats)
            torch.cuda.synchronize()
            err32 = (k32 - truth).abs()
            err16 = (k16 - truth).abs()
            err_plain16 = (plain_bf16 - truth).abs()
            r = dict(points=n_rays * S,
                     f32_max_abs_err=err32.max().item(),
                     f32_mean_abs_err=err32.mean().item(),
                     bf16_vs_plain_bf16_max_abs_err=(
                         k16 - plain_bf16).abs().max().item(),
                     bf16_vs_plain_bf16_mean_abs_err=(
                         k16 - plain_bf16).abs().mean().item(),
                     bf16_vs_f32_mean_abs_err=err16.mean().item(),
                     bf16_vs_f32_q99_abs_err=torch.quantile(
                         err16.flatten()[:2 ** 24], 0.99).item(),
                     plain_bf16_vs_f32_mean_abs_err=err_plain16.mean().item())
            # tolerances: f32 max abs err 1e-4; bf16 the JAX package's
            # bounds against the f32 truth, and a mean abs diff to the
            # plain bf16 version of 1e-4 (both round at the same points; a
            # rare one-ulp flip in a layer output moves single points)
            check(r["f32_max_abs_err"] <= 1e-4
                  and r["bf16_vs_plain_bf16_mean_abs_err"] <= 1e-4,
                  f"K1 disagrees with its plain version ({key}): {r}")
            check(r["bf16_vs_f32_mean_abs_err"]
                  <= 2 * r["plain_bf16_vs_f32_mean_abs_err"] + 5e-3
                  and r["bf16_vs_f32_q99_abs_err"] <= 0.25,
                  f"K1 bf16 out of bounds ({key}): {r}")
            res[key] = r
        # timing at the serving shape (one tile: chunk rays x N_samples)
        pts, dirs, feats = mlp_inputs(cfg.chunk, S, cfg.feat_dim, 1, dev)
        before = fused_nerf_mlp.launches
        times = {
            "bf16_ms": time_ms(lambda: fused["bfloat16"](pts, dirs, feats)),
            "f32_ms": time_ms(lambda: fused["float32"](pts, dirs, feats)),
            "plain_bf16_ms": time_ms(
                lambda: nerf["bfloat16"](pts, dirs, feats), iters=5),
            "plain_f32_ms": time_ms(
                lambda: nerf["float32"](pts, dirs, feats), iters=5)}
        fused_nerf_mlp.launches = before   # comparison launches do not count
    wbytes = {dt: f.packed.weights.numel() * f.packed.weights.element_size()
              + f.packed.biases.numel() * 4 for dt, f in fused.items()}
    flops, nbytes, macs = mlp_work(cfg, cfg.chunk, S, wbytes["bfloat16"])
    flops32, nbytes32, _ = mlp_work(cfg, cfg.chunk, S, wbytes["float32"])
    bound = {"bf16": max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3,
             "f32": max(flops32 / PEAK_F32, nbytes32 / PEAK_BYTES) * 1e3}
    res.update(times, macs_per_point=macs, flops=flops, bytes=nbytes,
               bound_bf16_ms=bound["bf16"], bound_f32_ms=bound["f32"],
               bound_by_bf16=("operations" if flops / PEAK_BF16
                              >= nbytes / PEAK_BYTES else "bytes"),
               # achieved rate and the share of the bound reached
               bf16_tflops=flops / times["bf16_ms"] / 1e9,
               f32_tflops=flops32 / times["f32_ms"] / 1e9,
               bf16_bound_share=bound["bf16"] / times["bf16_ms"],
               f32_bound_share=bound["f32"] / times["f32_ms"],
               # registers, spill (local) bytes, dynamic shared memory and
               # residency of each kernel, read back from the runtime
               attrs={dt: kernel_attrs(dt == "bf16", cfg.view_num)
                      for dt in ("bf16", "f32")})
    log("k1", **res)
    return res


def kernel_vs_plain_frame(cfg, params, batch, img_hw, dev) -> tuple:
    """One frame rendered with K1 and with the plain MLP (at
    ``cfg.nerf_dtype``) from ONE cascade output, so the diff is the MLP's
    alone (the cascade's cuDNN convolutions need not be bit-reproducible):
    (diff, K1's rgb [H, W, 3]).  The caller resets K1's launch count
    after."""
    from ucnerf_torch.kernels.fused_mlp import FusedNeRFMLP
    from ucnerf_torch.models.factory import create_models
    from ucnerf_torch.render.renderer import render_image_chunked
    from ucnerf_torch.train.loop import prepare_view_ctx, view_chunk_fns

    H, W = img_hw
    nerf, mvs = create_models(cfg, dev, params)
    got = {}
    with torch.no_grad():
        src = mvs.features(batch["images"][1:])
        ctx = prepare_view_ctx(
            cfg, mvs, batch, mvs_apply=lambda imgs, a, ai, n, f, p:
            mvs.from_features(src, a, ai, n, f, p))
        for name, mlp in (("kernel", FusedNeRFMLP(nerf)), ("plain", nerf)):
            fns = view_chunk_fns(cfg, mlp, H, W, ctx)
            got[name] = [t.cpu().numpy() for t in render_image_chunked(
                *fns, H, W, cfg.chunk, dev)]
    d_rgb = np.abs(got["kernel"][0] - got["plain"][0])
    d_depth = np.abs(got["kernel"][1] - got["plain"][1])
    return dict(rgb_max_abs=float(d_rgb.max()),
                rgb_mean_abs=float(d_rgb.mean()),
                depth_max_abs=float(d_depth.max()),
                depth_mean_rel=float((d_depth / np.abs(
                    got["plain"][1]).clip(1e-6)).mean())), got["kernel"][0]


def phase_serving(cfg, dev):
    """>= 3 requests through ucnerf_torch.serve's batch mode, then one frame
    again with the plain MLP (bf16 and f32) for the kernel-vs-plain diff."""
    from ucnerf_torch import serve
    from ucnerf_torch.kernels.fused_mlp import fused_nerf_mlp
    from ucnerf_torch.data import build_dataset

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    ds = build_dataset(cfg, "val")
    poses = [ds.scene[ds.metas[i][0]]["c2ws"][ds.metas[i][1]]
             for i in range(N_REQUESTS)]
    reqs = OUT_DIR / "requests.jsonl"
    outs = [str(OUT_DIR / f"frame_{i:03d}.npz") for i in range(N_REQUESTS)]
    with open(reqs, "w") as fh:
        for c2w, out in zip(poses, outs):
            fh.write(json.dumps({"c2w": np.asarray(c2w).tolist(),
                                 "out": out}) + "\n")
        fh.write('{"c2w": [[1, 2], [3, 4]], "out": "bad.npz"}\n')

    buf = io.StringIO()
    fused_nerf_mlp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        n = serve.main(["--requests", str(reqs), *SERVE_ARGS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_nerf_mlp.launches
    lines = buf.getvalue().splitlines()
    (OUT_DIR / "serve_stdout.txt").write_text(buf.getvalue())
    summary = json.loads(next(ln for ln in lines if ln.startswith('{"frames"')))
    errors = [ln for ln in lines if ln.startswith('{"error"')]
    n_tiles = -(-cfg.img_wh[0] * cfg.img_wh[1] // cfg.chunk)
    check(n == N_REQUESTS and len(errors) == 1,
          f"serve answered {n} requests, errors {errors}")
    check(launches == (N_REQUESTS + 1) * n_tiles,    # + the warm-up frame
          f"K1 launches {launches}, expected {(N_REQUESTS + 1) * n_tiles}")
    W, H = cfg.img_wh
    frames = [np.load(o) for o in outs]
    for i, f in enumerate(frames):
        check(f["rgb"].shape == (H, W, 3) and f["depth"].shape == (H, W)
              and f["confidence"].shape == (H, W), f"frame {i} shapes")
        check(all(np.isfinite(f[k]).all()
                  for k in ("rgb", "depth", "confidence")),
              f"frame {i} is not finite")
        check(f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0,
              f"frame {i} rgb outside [0, 1]")

    # steady-state frame time and kernel-vs-plain frames on request 0
    renderer, _ = serve.build_renderer(cfg)
    c2w = np.asarray(poses[0], np.float32)
    with torch.no_grad():
        ms_frame = time_ms(lambda: renderer.render(c2w), iters=5, warmup=1)
        profile = profile_frame(lambda: renderer.render(c2w))
    params = serve.load_params(cfg, dev)
    diffs = {dt: kernel_vs_plain_frame(cfg.replace(nerf_dtype=dt), params,
                                       renderer.frame_batch(c2w), (H, W),
                                       dev)[0]
             for dt in ("bfloat16", "float32")}
    fused_nerf_mlp.launches = launches   # comparison launches do not count
    check(diffs["float32"]["rgb_max_abs"] <= 1e-3
          and diffs["float32"]["depth_mean_rel"] <= 1e-4,
          f"f32 kernel frame vs plain frame: {diffs}")
    check(diffs["bfloat16"]["rgb_mean_abs"] <= 5e-3
          and diffs["bfloat16"]["depth_mean_rel"] <= 5e-3,
          f"bf16 kernel frame vs plain frame: {diffs}")
    res = dict(requests=n, frames_ok=len(frames), launches=launches,
               launches_per_frame=launches // (N_REQUESTS + 1),
               serve_ms_per_frame=summary["ms_per_frame"],
               serve_wall_s=wall, steady_ms_per_frame=ms_frame,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               kernel_vs_plain_frame=diffs, frame_profile=profile)
    log("serving", **res)
    return res


FRAME_KEYS = ("rgb", "depth", "confidence")


def frame_diff(got, want) -> dict:
    """Max and mean abs differences of two frames, each (rgb, depth,
    confidence)."""
    out = {}
    for k, g, w in zip(FRAME_KEYS, got, want):
        d = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        out[f"{k}_max_abs"] = float(d.max())
        out[f"{k}_mean_abs"] = float(d.mean())
    return out


def phase_http(cfg, dev):
    """``make_http_server`` on a free port at the serving point: GET
    /health; on the card's default kernels N_HTTP npz renders of the first
    serving pose, each held to that pose's batch-mode frame within
    HTTP_TOL; then, on deterministic kernels, the renderer's own frame of
    the pose, the npz request (bit for bit that frame) and the png request
    (``decode_png`` gives its 8-bit rgb); and a bad request (400)."""
    import threading
    import urllib.error
    import urllib.request
    from ucnerf_torch import serve
    from ucnerf_torch.kernels.fused_mlp import fused_nerf_mlp
    from ucnerf_torch.utils.platform import deterministic_kernels
    from ucnerf_torch.utils.png import decode_png

    renderer, meta = serve.build_renderer(cfg)
    c2w = json.loads((OUT_DIR / "requests.jsonl").read_text()
                     .splitlines()[0])["c2w"]
    with np.load(OUT_DIR / "frame_000.npz") as f:
        batch_frame = [f[k] for k in FRAME_KEYS]
    srv = serve.make_http_server(renderer, meta, port=0)
    th = threading.Thread(target=srv.serve_forever, args=(0.05,),
                          daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(body):
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(
                url + "/render", data=json.dumps(body).encode()),
                timeout=300) as r:
            return r.read(), r.headers["Content-Type"], (
                time.perf_counter() - t0) * 1e3

    fused_nerf_mlp.launches = 0
    try:
        with urllib.request.urlopen(url + "/health", timeout=300) as r:
            code, health = r.status, json.loads(r.read())
        check(code == 200 and health["ok"] and "probe_ms" in health
              and health["img_wh"] == list(cfg.img_wh),
              f"GET /health: {code} {health}")
        ms, frames = [], []
        for _ in range(N_HTTP):
            payload, ctype, t = post({"c2w": c2w})
            ms.append(t)
            check(ctype == "application/octet-stream", f"npz as {ctype}")
            with np.load(io.BytesIO(payload)) as f:
                frames.append([f[k] for k in FRAME_KEYS])
        vs_batch = [frame_diff(f, batch_frame) for f in frames]
        spread = frame_diff(frames[1], frames[0])
        check(all(d[k] <= HTTP_TOL for d in vs_batch
                  for k in ("rgb_mean_abs", "depth_mean_abs",
                            "confidence_mean_abs")),
              f"POST /render npz vs the batch-mode frame: {vs_batch}")
        with deterministic_kernels():
            want = renderer.render_np(np.asarray(c2w, np.float32))
            npz, _, _ = post({"c2w": c2w})
            with np.load(io.BytesIO(npz)) as f:
                got = [f[k] for k in FRAME_KEYS]
            png, ctype, png_ms = post({"c2w": c2w, "format": "png"})
        det = frame_diff(got, want)
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              f"POST /render npz is not the renderer's frame on "
              f"deterministic kernels: {det}")
        check(ctype == "image/png" and np.array_equal(
            decode_png(png), (np.clip(want[0], 0, 1) * 255)
            .astype(np.uint8)), "POST /render png is not the 8-bit frame")
        try:
            post({"c2w": [[1, 2], [3, 4]]})
            bad = None
        except urllib.error.HTTPError as e:
            bad = e.code
        check(bad == 400, f"a malformed request got {bad}, not 400")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(60)
    launches = fused_nerf_mlp.launches
    n_frames = N_HTTP + 3
    n_tiles = -(-cfg.img_wh[0] * cfg.img_wh[1] // cfg.chunk)
    check(launches == n_frames * n_tiles,
          f"K1 launches {launches}, expected {n_frames * n_tiles}")
    res = dict(probe_ms=health["probe_ms"], npz_ms=ms, png_ms=png_ms,
               ms_per_request=float(np.median(ms[1:])), frames=n_frames,
               launches=launches, npz_vs_batch=vs_batch,
               default_kernels_spread=spread, deterministic_vs_renderer=det)
    log("http", **res)
    return res


def phase_render_path(cfg):
    """``python -m ucnerf_torch.render_path``: an interp trajectory of
    PATH_FRAMES frames at the serving point, written as npz."""
    from ucnerf_torch import render_path
    from ucnerf_torch.kernels.fused_mlp import fused_nerf_mlp

    out = OUT_DIR / "render_path.npz"
    buf = io.StringIO()
    fused_nerf_mlp.launches = 0
    with contextlib.redirect_stdout(buf):
        rp = render_path.main(["--traj", "interp", "--n_frames",
                               str(PATH_FRAMES), "--out", str(out),
                               *SERVE_ARGS])
    launches = fused_nerf_mlp.launches
    (OUT_DIR / "render_path_stdout.txt").write_text(buf.getvalue())
    data = np.load(out)
    W, H = cfg.img_wh
    n_tiles = -(-W * H // cfg.chunk)
    check(rp["out"] == str(out) and data["rgb"].shape == (PATH_FRAMES, H, W, 3)
          and data["depth"].shape == (PATH_FRAMES, H, W),
          f"render_path wrote {rp} {data['rgb'].shape}")
    check(np.isfinite(data["rgb"]).all() and np.isfinite(data["depth"]).all()
          and data["rgb"].min() >= 0.0 and data["rgb"].max() <= 1.0,
          "render_path frames not finite or rgb outside [0, 1]")
    check(launches == PATH_FRAMES * n_tiles,
          f"K1 launches {launches}, expected {PATH_FRAMES * n_tiles}")
    res = dict(frames=rp["frames"], wall_s=rp["wall_s"],
               steady_ms_per_frame=rp["steady_ms_per_frame"],
               launches=launches)
    log("render_path", **res)
    return res


@contextlib.contextmanager
def bench_scene():
    """The synthetic scene as bench.py builds it for its train point
    (n_sparse=1024, n_images=16, so every sparse-depth slot holds a ray)
    in place of the registry's default while the block runs."""
    from ucnerf_torch import data
    from ucnerf_torch.data.synthetic import SyntheticDataset

    class BenchScene(SyntheticDataset):
        def __init__(self, *args, **kw):
            super().__init__(*args, **{**kw, "n_sparse": 1024,
                                       "n_images": 16})

    data.dataset_dict["synthetic"] = BenchScene
    try:
        yield
    finally:
        data.dataset_dict["synthetic"] = SyntheticDataset


def grad_envelope(got: dict, want: dict) -> dict:
    """Per tensor: max abs diff over the larger max abs; the median and
    the worst over all tensors."""
    rels = {}
    for name, w in want.items():
        g = got[name]
        scale = max(w.abs().max().item(), g.abs().max().item(), 1e-10)
        rels[name] = (g - w).abs().max().item() / scale
    worst = max(rels, key=rels.get)
    return dict(n_tensors=len(rels),
                median=float(np.median(list(rels.values()))),
                worst=rels[worst], worst_tensor=worst)


def card_vs_cpu_step(dev) -> dict:
    """One loss and its gradients at the CPU tests' small shape, with the
    same weights and the same draws, on the card and on the CPU (float32,
    TF32 off)."""
    from ucnerf_torch.config import parse_config
    from ucnerf_torch.data import build_dataset
    from ucnerf_torch.models.factory import create_models, init_params
    from ucnerf_torch.ops.rays import TrainDraws, draw_train_randomness
    from ucnerf_torch.render.serving import to_device_batch
    from ucnerf_torch.train.loop import scene_loss

    cfg = parse_config(SMALL_ARGS)
    sample = build_dataset(cfg, "train")[0]
    H, W = sample["images"].shape[1:3]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    draws = draw_train_randomness(
        torch.Generator().manual_seed(1), H=H, W=W,
        patch_size=cfg.patch_size, patch_num=cfg.patch_num,
        n_uniform=cfg.n_uniform_rays, n_rays=cfg.n_train_rays,
        n_samples=cfg.N_samples)
    out = []
    for d in (torch.device("cpu"), dev):
        nerf, mvs = create_models(cfg, d, params)
        loss, _ = scene_loss(cfg, nerf, mvs, to_device_batch(sample, d),
                             TrainDraws(*(t.to(d) for t in draws)))
        loss.backward()
        grads = {n: p.grad.cpu() for m in (nerf, mvs)
                 for n, p in m.named_parameters()}
        out.append((float(loss.detach()), grads))
    (loss_cpu, g_cpu), (loss_card, g_card) = out
    return dict(loss_cpu=loss_cpu, loss_card=loss_card,
                loss_rel=abs(loss_card - loss_cpu) / abs(loss_cpu),
                grads=grad_envelope(g_card, g_cpu))


def run_trainer(name: str, *argv, base=TRAIN_ARGS) -> tuple:
    """One ``ucnerf_torch.train`` run (on the bench scene unless ``base``
    names another dataset) under OUT_DIR/``name``: (summary, JSON lines,
    wall seconds); its output is kept in OUT_DIR/``name``_stdout.txt."""
    from ucnerf_torch.train import __main__ as train_cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with bench_scene(), contextlib.redirect_stdout(buf):
        summary = train_cli.main([*base, "--basedir", str(OUT_DIR),
                                  "--expname", name, *argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (OUT_DIR / f"{name}_stdout.txt").write_text(buf.getvalue())
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    return summary, lines, wall


def step_lines(lines) -> list:
    return [ln for ln in lines if "step" in ln]


def store_vs_host(cfg, dev) -> dict:
    """One train sample store-fed and host-fed on the card: the batches
    bit for bit (less the eval-only GT depth), and the forward loss of each
    with the same weights and draws."""
    from ucnerf_torch.data import build_dataset
    from ucnerf_torch.data.device_store import (build_store, gather_batch,
                                                sample_indices, store_nbytes)
    from ucnerf_torch.models.factory import create_models, init_params
    from ucnerf_torch.ops.rays import draw_train_randomness
    from ucnerf_torch.render.serving import to_device_batch
    from ucnerf_torch.train.loop import scene_loss

    with bench_scene():
        ds = build_dataset(cfg, "train")
    ds.set_epoch(1)
    store = build_store(ds, dev)
    host = to_device_batch(ds[5], dev)
    fed = gather_batch(store, to_device_batch(sample_indices(ds, 5), dev))

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            elif k != "depths_h":
                yield prefix + k, v
    h, s = dict(flat(host)), dict(flat(fed))
    unequal = sorted(k for k in h if k not in s or h[k].dtype != s[k].dtype
                     or not torch.equal(h[k], s[k]))
    W, H = cfg.img_wh
    nerf, mvs = create_models(cfg, dev, init_params(
        cfg, torch.Generator().manual_seed(cfg.seed), dev))
    losses = []
    for batch in (host, fed):
        draws = draw_train_randomness(
            torch.Generator(device=dev).manual_seed(3), H=H, W=W,
            patch_size=cfg.patch_size, patch_num=cfg.patch_num,
            n_uniform=cfg.n_uniform_rays, n_rays=cfg.n_train_rays,
            n_samples=cfg.N_samples)
        with torch.no_grad():
            losses.append(float(scene_loss(cfg, nerf, mvs, batch, draws)[0]))
    return dict(store_mb=store_nbytes(store) / 1e6, fields=len(h),
                unequal_fields=unequal, loss_host=losses[0],
                loss_store=losses[1],
                loss_rel=abs(losses[1] - losses[0]) / abs(losses[0]))


def phase_train(dev):
    """ucnerf_torch.train's entry point at the train point, on the bench
    scene: (a) TRAIN_STEPS store-fed steps that stop at a checkpoint and do
    not validate; (b) a resume from it to RESUME_STEPS against as many
    uninterrupted host-fed steps; (c) ``--eval`` of the checkpoint over the
    whole val split on K1 with ``--val_panels all``, then K1 vs the plain
    MLP on its first view; (d) one sample store-fed against host-fed.  (a)
    and (b) run with the trainer's ``--deterministic``, (d) under the same
    ``deterministic_kernels``, so that their comparisons see the code and
    not the card's atomics.  Then an overfit of one sample through
    make_train_step (default kernels), its last step profiled, the same
    step on deterministic kernels, and one small-shape step on the card vs
    the CPU."""
    from ucnerf_torch.config import parse_config
    from ucnerf_torch.data import build_dataset
    from ucnerf_torch.data.base import unnormalize_image
    from ucnerf_torch.kernels.fused_mlp import fused_nerf_mlp
    from ucnerf_torch.models.factory import create_models, init_params
    from ucnerf_torch.ops.rays import draw_train_randomness
    from ucnerf_torch.render.serving import to_device_batch
    from ucnerf_torch.train import validation
    from ucnerf_torch.train.loop import (TrainState, make_lr_schedule,
                                         make_optimizer, make_train_step)
    from ucnerf_torch.utils import checkpoint_io
    from ucnerf_torch.utils.platform import deterministic_kernels
    from ucnerf_torch.utils.png import read_png
    from ucnerf_torch.utils.viz import PAD, STRIP, visualize_depth
    save_val_panel = validation.save_val_panel

    cfg = parse_config(TRAIN_ARGS)
    W, H = cfg.img_wh
    n_tiles = -(-W * H // cfg.chunk)
    terms = ("loss", "img_mse", "nerf_depth", "mvs", "smooth", "scaleinv",
             "psnr")
    runs = ("a_train", "b_resumed", "b_whole", "c_eval")
    for name in runs:
        shutil.rmtree(OUT_DIR / name, ignore_errors=True)
    fused_nerf_mlp.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # (a) train to a checkpoint: stopped runs save and do not validate
    summary, lines, wall = run_trainer("a_train", "--deterministic",
                                       "--stop_after_steps", str(TRAIN_STEPS))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = step_lines(lines)
    ckpt = OUT_DIR / "a_train" / "ckpts" / f"step_{TRAIN_STEPS:08d}"
    saves = [ln for ln in lines if "checkpoint" in ln]
    store = [ln for ln in lines if "store_mb" in ln]
    check(len(steps) == TRAIN_STEPS and all(
        np.isfinite([ln[k] for k in terms]).all() for ln in steps),
        f"train steps not all finite: {steps}")
    check((ckpt / "params.npz").is_file() and (ckpt / "train_state.pt")
          .is_file() and [s["checkpoint"] for s in saves] == [str(ckpt)],
          f"no checkpoint at step {TRAIN_STEPS}: {saves}")
    check(summary["stopped"] and summary["val"] is None
          and not any("val_step" in ln for ln in lines),
          f"a stopped run validated: {summary}")
    check(len(store) == 1, f"the default run is not store-fed: {store}")
    ms = [ln["ms"] for ln in steps]
    steady_ms = float(np.median(ms[2:]))

    # (b) resume against an uninterrupted (host-fed) run
    host_cfg = OUT_DIR / "host_fed.json"
    host_cfg.write_text(json.dumps({"device_dataset": False}))
    _, r_lines, _ = run_trainer("b_resumed", "--deterministic", "--ckpt",
                                str(ckpt), "--stop_after_steps",
                                str(RESUME_STEPS))
    _, u_lines, _ = run_trainer("b_whole", "--deterministic", "--config",
                                str(host_cfg), "--stop_after_steps",
                                str(RESUME_STEPS))
    resumed = step_lines(r_lines)
    whole = step_lines(u_lines)[TRAIN_STEPS:]
    loss_rel = [abs(r["loss"] - u["loss"]) / abs(u["loss"])
                for r, u in zip(resumed, whole)]
    resume = dict(
        resumed_steps=[ln["step"] for ln in resumed],
        resumed_lr=[ln["lr"] for ln in resumed],
        whole_lr=[ln["lr"] for ln in whole],
        resumed_loss=[ln["loss"] for ln in resumed],
        whole_loss=[ln["loss"] for ln in whole], loss_rel=loss_rel,
        whole_steady_ms=float(np.median(
            [ln["ms"] for ln in step_lines(u_lines)[2:]])),
        resumed_from=[ln for ln in r_lines if "resumed" in ln])
    log("resume", **resume)
    # both runs on deterministic kernels: every term and LR of the resumed
    # steps equals the uninterrupted run's bit for bit
    check(resume["resumed_steps"] == list(range(TRAIN_STEPS + 1,
                                                RESUME_STEPS + 1))
          and len(resumed) == len(whole) == RESUME_STEPS - TRAIN_STEPS
          and all(r[k] == u[k] for r, u in zip(resumed, whole)
                  for k in (*terms, "lr")),
          f"resume vs uninterrupted, not bit for bit: {resume}")
    check(fused_nerf_mlp.launches == 0,
          f"stopped runs launched K1 {fused_nerf_mlp.launches} times")

    # (c) --eval of the checkpoint over the whole val split on K1, with a
    # panel per view; the predictions each panel was drawn from are kept
    with bench_scene():
        val_ds = build_dataset(cfg, "val")
    drawn = []

    def recording(path, gt_rgb, pred_rgb, gt_depth, pred_depth):
        drawn.append((path, pred_depth))
        save_val_panel(path, gt_rgb, pred_rgb, gt_depth, pred_depth)
    validation.save_val_panel = recording
    try:
        ev_summary, ev_lines, ev_wall = run_trainer(
            "c_eval", "--eval", "--ckpt", str(ckpt), "--val_panels", "all")
    finally:
        validation.save_val_panel = save_val_panel
    launches = fused_nerf_mlp.launches
    [val] = [ln for ln in ev_lines if "val_step" in ln]
    metrics = ev_summary["val"]
    finite = [k for k in metrics if k != "lpips"]
    check(val["views"] == len(val_ds) and launches == len(val_ds) * n_tiles,
          f"K1 launches {launches} over {val['views']} views, expected "
          f"{len(val_ds)} x {n_tiles}")
    check(len(finite) == 9 and np.isfinite([metrics[k] for k in finite]).all()
          and np.isnan(metrics["lpips"]),
          f"validation metrics: {metrics}")
    check((OUT_DIR / "c_eval" / "test_results" / "rgb_evaluation.txt")
          .is_file(), "no rgb_evaluation.txt")
    # a panel per view: its shape, and its rendered-depth tile is the
    # depth colormap of the prediction it was drawn from
    results = OUT_DIR / "c_eval" / "test_results"
    check(val["panels"] == len(val_ds) == len(drawn)
          and sorted(p for p, _ in drawn) == [
              str(results / f"00000000_{i:02d}.png")
              for i in range(len(val_ds))],
          f"panels: {val.get('panels')} written, {len(drawn)} drawn")
    for path, pred_depth in drawn:
        panel = read_png(path)
        check(panel.shape == (2 * (STRIP + H) + PAD, 2 * W + PAD, 3),
              f"panel {path}: shape {panel.shape}")
        check(np.array_equal(panel[2 * STRIP + H + PAD:, W + PAD:],
                             visualize_depth(pred_depth)),
              f"panel {path}: depth tile is not the prediction's colormap")

    # K1 vs the plain bf16 MLP on the checkpoint's first val view
    trained = checkpoint_io.checkpoint_params(str(ckpt))
    diff, k1_rgb = kernel_vs_plain_frame(cfg, trained,
                                         to_device_batch(val_ds[0], dev),
                                         (H, W), dev)
    fused_nerf_mlp.launches = launches   # comparison launches do not count
    check(diff["rgb_mean_abs"] <= 5e-3 and diff["depth_mean_rel"] <= 5e-3,
          f"bf16 kernel validation frame vs plain frame: {diff}")
    # the panels hold their own views: panel i's GT tile is val view i's
    # image bit for bit, and panel 0's rendered tile is view 0 as rendered
    # anew just above, within PANEL_TOL
    panel_vs_render = {}
    for i in range(len(val_ds)):
        panel = read_png(str(results / f"00000000_{i:02d}.png"))
        gt = np.clip(unnormalize_image(val_ds[i]["images"][0]), 0, 1)
        check(np.array_equal(panel[STRIP:STRIP + H, :W],
                             (gt * 255).astype(np.uint8)),
              f"panel {i}: GT tile is not val view {i}'s image")
        if i < 2:
            d = np.abs(panel[STRIP:STRIP + H, W + PAD:].astype(np.int16)
                       - (np.clip(k1_rgb, 0, 1) * 255).astype(np.int16))
            panel_vs_render[i] = dict(mean_levels=float(d.mean()),
                                      share_over_1=float((d > 1).mean()))
    log("panels", vs_view0_render=panel_vs_render)
    check(panel_vs_render[0]["mean_levels"] <= PANEL_TOL[0]
          and panel_vs_render[0]["share_over_1"] <= PANEL_TOL[1],
          f"panel 0's rendered tile is not view 0's render: "
          f"{panel_vs_render}")

    # (d) one sample store-fed against host-fed
    with deterministic_kernels():
        svh = store_vs_host(cfg, dev)
    log("store_vs_host", **svh)
    check(not svh["unequal_fields"] and svh["loss_rel"] <= 1e-6,
          f"store-fed vs host-fed: {svh}")

    # overfit one fixed sample; the last step under the profiler
    with bench_scene():
        batch = to_device_batch(build_dataset(cfg, "train")[0], dev)
    nerf, mvs = create_models(cfg, dev, init_params(
        cfg, torch.Generator().manual_seed(cfg.seed), dev))
    state = TrainState(nerf, mvs, make_optimizer(cfg, nerf, mvs))
    step = make_train_step(cfg, make_lr_schedule(cfg, cfg.samples_per_scene))
    gen = torch.Generator(device=dev).manual_seed(1)
    draw_kw = dict(H=H, W=W, patch_size=cfg.patch_size,
                   patch_num=cfg.patch_num, n_uniform=cfg.n_uniform_rays,
                   n_rays=cfg.n_train_rays, n_samples=cfg.N_samples)
    losses, overfit_ms = [], []
    for i in range(OVERFIT_STEPS):
        draws = draw_train_randomness(gen, **draw_kw)
        run = lambda: losses.append(float(step(state, batch, draws)["loss"]))
        if i == OVERFIT_STEPS - 1:
            profile = profile_frame(run, name="train_profile.txt")
        else:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run()
            overfit_ms.append((time.perf_counter() - t1) * 1e3)
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    check(np.isfinite(losses).all() and last <= 0.9 * first,
          f"overfit loss did not drop by 10%: {losses}")
    # the same step on deterministic kernels: what exact resume costs
    det_ms = []
    with deterministic_kernels():
        for _ in range(DET_STEPS):
            draws = draw_train_randomness(gen, **draw_kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            check(np.isfinite(float(step(state, batch, draws)["loss"])),
                  "deterministic step not finite")
            det_ms.append((time.perf_counter() - t1) * 1e3)


    for name in runs:      # the checkpoints have served; keep the output small
        shutil.rmtree(OUT_DIR / name / "ckpts", ignore_errors=True)

    cc = card_vs_cpu_step(dev)
    check(abs(cc["loss_rel"]) <= 1e-4 and cc["grads"]["median"] < 5e-3
          and cc["grads"]["worst"] < 3e-2,
          f"card vs CPU loss/gradients out of bounds: {cc}")

    overfit_ms_median = float(np.median(overfit_ms[2:]))
    res = dict(steps=len(steps), step_ms=ms,
               # the CLI runs, on deterministic kernels
               det_steady_ms_per_step=steady_ms,
               det_host_fed_steady_ms_per_step=resume["whole_steady_ms"],
               rays_per_step=cfg.n_train_rays,
               # the step on the card's default kernels (the overfit loop)
               steady_ms_per_step=overfit_ms_median,
               det_kernels_ms_per_step=float(np.median(det_ms[2:])),
               train_rays_per_s=cfg.n_train_rays / overfit_ms_median * 1e3,
               peak_mem_gib=peak_gib, cli_wall_s=wall, summary=summary,
               ckpt_save_s=saves[0]["seconds"], store_mb=store[0]["store_mb"],
               resume=resume, eval_views=val["views"],
               eval_ms_per_view=val["ms_per_view"], eval_wall_s=ev_wall,
               eval_metrics=metrics, k1_launches=launches,
               eval_panels=val["panels"],
               panel_ms_per_view=val["panel_ms_per_view"],
               k1_launches_expected=len(val_ds) * n_tiles,
               kernel_vs_plain_val_frame=diff,
               panels_vs_view0_render=panel_vs_render, store_vs_host=svh,
               overfit_losses=losses, overfit_drop=1.0 - last / first,
               step_profile=profile,
               device_idle_share=profile["device_idle_share"],
               card_vs_cpu=cc)
    log("train", **res)
    return res

def fabricate_scan(scene: Path, seed: int = 0) -> dict:
    """A SCARED-layout scan written with the port's own writers: a textured
    tilted plane about 10 cm away seen by SCAN_FRAMES cameras 2 mm apart at
    SCAN_WH; frames as PNG (``utils/png.py``), GT depth as 16-bit PNG in
    millimetres, a DPT ``pred`` npz per frame at SCAN_DPT_WH, a COLMAP
    ``sparse/0`` of SCAN_POINTS plane points with their tracks, and
    ``poses_bounds.npy`` from ``gen_poses``.  The loaders take the DPT
    prior at the frame's path with "images" -> "dpt" and "jpeg" -> "npz",
    so next to a PNG frame it is an npz archive named ``<stem>.png``."""
    from ucnerf_torch.data import colmap
    from ucnerf_torch.data.llff import gen_poses
    from ucnerf_torch.utils.png import write_png

    rng = np.random.default_rng(seed)
    W, H = SCAN_WH
    f = 1100.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    for sub in ("images", "depths", "dpt", "sparse/0"):
        (scene / sub).mkdir(parents=True, exist_ok=True)
    # plane z = z0 + a x + b y (metres, world frame = camera 0's)
    z0, a, b = 0.10, 0.15, -0.08

    def texture(x, y):
        u, v = 90.0 * x, 90.0 * y
        r = 0.55 + 0.25 * np.sin(2.1 * u + 0.3) + 0.15 * np.cos(1.3 * v)
        g = 0.35 + 0.2 * np.sin(1.7 * u + 1.1 * v) + 0.1 * np.cos(2.9 * v)
        bl = 0.3 + 0.2 * np.cos(1.1 * u - 0.7 * v) + 0.1 * np.sin(3.1 * v)
        return np.clip(np.stack([r, g, bl], -1), 0.02, 0.98)

    us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    rays = np.stack([(us - K[0, 2]) / f, (vs - K[1, 2]) / f,
                     np.ones_like(us)], -1)
    dus, dvs = np.meshgrid(np.linspace(0, W - 1, SCAN_DPT_WH[0]),
                           np.linspace(0, H - 1, SCAN_DPT_WH[1]))
    cams = {1: colmap.Camera(1, "PINHOLE", W, H,
                             np.array([f, f, W / 2, H / 2]))}
    # sparse points on the plane, inside the view of every camera
    px = rng.uniform(-0.035, 0.035, SCAN_POINTS)
    py = rng.uniform(-0.03, 0.03, SCAN_POINTS)
    pts = np.stack([px, py, z0 + a * px + b * py], -1)
    tracks = {pid: ([], []) for pid in range(1, SCAN_POINTS + 1)}
    images = {}
    for i in range(SCAN_FRAMES):
        yaw = 0.01 * np.sin(2 * np.pi * i / SCAN_FRAMES)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])        # world -> cam
        t = np.array([-0.002 * (i - SCAN_FRAMES / 2),
                      0.001 * np.cos(2 * np.pi * i / SCAN_FRAMES), 0.0])
        c2w_R, center = R.T, -R.T @ t
        d = rays @ c2w_R.T                                     # world rays
        hit = ((z0 + a * center[0] + b * center[1] - center[2])
               / (d[..., 2] - a * d[..., 0] - b * d[..., 1]))  # cam z-depth
        p = center + hit[..., None] * d
        stem = f"frame_{i:03d}"
        write_png(str(scene / "images" / f"{stem}.png"),
                  (texture(p[..., 0], p[..., 1]) * 255).astype(np.uint8))
        write_png(str(scene / "depths" / f"{stem}.png"),
                  np.round(hit * 1000.0).astype(np.uint16))
        iy, ix = np.round(dvs).astype(int), np.round(dus).astype(int)
        with open(scene / "dpt" / f"{stem}.png", "wb") as fh:
            np.savez(fh, pred=(1.0 / hit[iy, ix])[None].astype(np.float32))
        pc = pts @ R.T + t
        uv = pc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        seen = ((uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
                & (uv[:, 1] < H) & (pc[:, 2] > 0))
        pids = np.nonzero(seen)[0] + 1
        for k, pid in enumerate(pids):
            tracks[pid][0].append(i + 1)
            tracks[pid][1].append(k)
        images[i + 1] = colmap.Image(i + 1, colmap.rotmat2qvec(R), t, 1,
                                     f"{stem}.png", uv[seen],
                                     pids.astype(np.int64))
    points = {pid: colmap.Point3D(pid, pts[pid - 1],
                                  np.array([128, 128, 128]),
                                  float(rng.uniform(0.2, 1.5)),
                                  np.array(tracks[pid][0], np.int32),
                                  np.array(tracks[pid][1], np.int32))
              for pid in tracks}
    colmap.write_model(cams, images, points, str(scene / "sparse" / "0"),
                       ext=".bin")
    gen_poses(str(scene))
    return dict(frames=SCAN_FRAMES, size=list(SCAN_WH),
                points=SCAN_POINTS,
                observations=int(sum(len(im.xys) for im in images.values())))


def scene_arrays_equal(a: dict, b: dict) -> list:
    """Names of the scene arrays that differ between two loads."""
    bad = [k for k in ("images", "depths", "dpt", "c2ws", "w2cs",
                       "intrinsic", "near_far", "bounds")
           if not np.array_equal(a[k], b[k])
           or np.asarray(a[k]).dtype != np.asarray(b[k]).dtype]
    if len(a["sparse"]) != len(b["sparse"]):
        return bad + ["sparse"]
    return bad + [f"sparse{i}_{k}" for i, (e, g) in
                  enumerate(zip(a["sparse"], b["sparse"]))
                  for k in ("depth_img", "weight_img", "coords", "depths",
                            "weights") if not np.array_equal(e[k], g[k])]


def load_breakdown(ds, scene: Path) -> dict:
    """The cold load's parts, timed again one by one over the whole scan
    (host clock): ms per frame to decode a frame, to resize it (the
    PIL-bilinear twin) and normalise it, to read and resize the GT depth,
    to read and resize the DPT prior; seconds to splat the sparse depth of
    the scan and to write its cache."""
    import tempfile
    from ucnerf_torch.data.base import (load_colmap_sparse_depth,
                                        normalize_image)
    from ucnerf_torch.data.image_io import read_frame
    from ucnerf_torch.data.llff import load_poses_bounds
    from ucnerf_torch.data.resize import pil_bilinear_u8

    frames = sorted((scene / "images").glob("*"))
    t = dict(decode=0.0, resize=0.0, depth=0.0, dpt=0.0)
    for p in frames:
        t0 = time.perf_counter()
        img = read_frame(str(p))
        t1 = time.perf_counter()
        normalize_image(pil_bilinear_u8(img, ds.img_wh).astype(np.float32)
                        / 255.0)
        t2 = time.perf_counter()
        ds._read_gt_depth(str(scene / "depths" / p.name))
        t3 = time.perf_counter()
        ds._read_dpt(str(scene / "dpt" / p.name))
        t4 = time.perf_counter()
        for k, a, b in (("decode", t0, t1), ("resize", t1, t2),
                        ("depth", t2, t3), ("dpt", t3, t4)):
            t[k] += b - a
    out = {f"{k}_ms_per_frame": v / len(frames) * 1e3 for k, v in t.items()}
    _, bds = load_poses_bounds(str(scene / "poses_bounds.npy"))
    t0 = time.perf_counter()
    load_colmap_sparse_depth(str(scene), ds.img_wh, 1.0 / ds.downsample, bds)
    out["splat_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=scene) as tmp:
        t0 = time.perf_counter()
        ds._save_cache(os.path.join(tmp, "cache.npz"), ds.scene[scene.name],
                       "timing")
        out["cache_write_s"] = time.perf_counter() - t0
    return out


def phase_jpeg() -> dict:
    """The committed JPEG fixtures decode to the SHA-256 of PIL's pixels
    recorded beside them; the 1280x1024 one is timed (host clock)."""
    import hashlib
    from ucnerf_torch.utils.jpeg import decode_jpeg

    record = json.loads((FIXTURES / "jpeg_fixtures.json").read_text())
    digests, ms = {}, None
    for name, want in record.items():
        data = (FIXTURES / name).read_bytes()
        img = decode_jpeg(data, name)
        digests[name] = hashlib.sha256(img.tobytes()).hexdigest()
        check(img.shape == (want["height"], want["width"], 3)
              and digests[name] == want["sha256"],
              f"JPEG fixture {name}: {img.shape}, digest {digests[name]} "
              f"is not PIL's {want['sha256']}")
        if (want["width"], want["height"]) == SCAN_WH:
            times = []
            for _ in range(7):
                t0 = time.perf_counter()
                decode_jpeg(data, name)
                times.append((time.perf_counter() - t0) * 1e3)
            ms = float(np.median(times))
    check(ms is not None, "no 1280x1024 JPEG fixture")
    return dict(fixtures=len(record), digests_equal=True,
                decode_ms_1280x1024=ms)


def phase_scared(dev, tr: dict) -> dict:
    """Phase scared on a fabricated SCARED-layout scan: (a) the scene
    loaded cold (decode, resize, splat) and warm from the scene cache, bit
    for bit; (b) TRAIN_STEPS store-fed steps through ``python -m
    ucnerf_torch.train --dataset_name scared``, beside phase train's
    ms/step; (c) ``--eval`` of that checkpoint over the val split on K1
    (launches = views x tiles, finite PSNR / SSIM and depth metrics
    against the GT depth), then K1 vs the plain MLP on its first view;
    (d) one ``serve`` request on the scan, an npz frame; (e) the JPEG
    fixtures on the card's machine."""
    from ucnerf_torch import serve
    from ucnerf_torch.config import parse_config
    from ucnerf_torch.data import build_dataset
    from ucnerf_torch.kernels.fused_mlp import fused_nerf_mlp
    from ucnerf_torch.render.serving import to_device_batch
    from ucnerf_torch.utils import checkpoint_io

    cfg = parse_config(SCAN_ARGS)
    shutil.rmtree(SCAN_DIR, ignore_errors=True)
    for name in ("s_train", "s_eval"):
        shutil.rmtree(OUT_DIR / name, ignore_errors=True)
    t0 = time.perf_counter()
    made = fabricate_scan(SCAN_DIR / "scene0")
    fabricate_s = time.perf_counter() - t0

    # (a) cold: no cache on disk; warm: the cache the cold load wrote
    t0 = time.perf_counter()
    cold = build_dataset(cfg, "train")
    cold_s = time.perf_counter() - t0
    check((SCAN_DIR / "scene0" / "_ucnerf_cache.npz").is_file(),
          "the cold load wrote no scene cache")
    t0 = time.perf_counter()
    warm = build_dataset(cfg, "train")
    warm_s = time.perf_counter() - t0
    unequal = scene_arrays_equal(cold.scene["scene0"],
                                 warm.scene["scene0"])
    sc = cold.scene["scene0"]
    n_sparse = [len(e["coords"]) for e in sc["sparse"]]
    W, H = cold.img_wh
    check(not unequal, f"warm load differs from the cold one: {unequal}")
    check(sc["images"].shape == (SCAN_FRAMES, H, W, 3)
          and (W, H) == tuple(int(x * cold.downsample) for x in SCAN_WH)
          and sc["depths"].min() > 0
          and sc["dpt"].min() > 0 and min(n_sparse) > 0,
          f"scene: {sc['images'].shape}, sparse points {n_sparse}")
    load = dict(cold_s=cold_s, cold_ms_per_frame=cold_s / SCAN_FRAMES
                * 1e3, warm_s=warm_s, fabricate_s=fabricate_s,
                sparse_points_per_view=n_sparse, scan=made,
                cache_mb=(SCAN_DIR / "scene0" / "_ucnerf_cache.npz")
                .stat().st_size / 1e6,
                breakdown=load_breakdown(cold, SCAN_DIR / "scene0"))

    # (b) train through the entry point, store-fed, default kernels
    fused_nerf_mlp.launches = 0
    summary, lines, wall = run_trainer(
        "s_train", "--stop_after_steps", str(TRAIN_STEPS),
        base=SCAN_ARGS)
    steps = step_lines(lines)
    terms = ("loss", "img_mse", "nerf_depth", "mvs", "smooth",
             "scaleinv", "psnr")
    check(len(steps) == TRAIN_STEPS and all(
        np.isfinite([ln[k] for k in terms]).all() for ln in steps),
        f"scared train steps not all finite: {steps}")
    check(any("store_mb" in ln for ln in lines),
          "the scared run is not store-fed")
    ms = [ln["ms"] for ln in steps]
    ckpt = OUT_DIR / "s_train" / "ckpts" / f"step_{TRAIN_STEPS:08d}"

    # (c) --eval over the val split on K1
    val_ds = build_dataset(cfg, "val")
    n_tiles = -(-W * H // cfg.chunk)
    fused_nerf_mlp.launches = 0
    ev_summary, ev_lines, ev_wall = run_trainer(
        "s_eval", "--eval", "--ckpt", str(ckpt), "--val_panels", "none",
        base=SCAN_ARGS)
    eval_launches = fused_nerf_mlp.launches
    [val] = [ln for ln in ev_lines if "val_step" in ln]
    metrics = ev_summary["val"]
    check(val["views"] == len(val_ds) == SCAN_FRAMES // 2
          and eval_launches == len(val_ds) * n_tiles,
          f"K1 launches {eval_launches} over {val['views']} views, "
          f"expected {len(val_ds)} x {n_tiles}")
    check(np.isfinite([metrics[k] for k in metrics if k != "lpips"]
                      ).all() and len(metrics) == 10,
          f"scared validation metrics: {metrics}")
    trained = checkpoint_io.checkpoint_params(str(ckpt))
    diff, _ = kernel_vs_plain_frame(cfg, trained,
                                    to_device_batch(val_ds[0], dev),
                                    (H, W), dev)
    check(diff["rgb_mean_abs"] <= 5e-3 and diff["depth_mean_rel"] <= 5e-3,
          f"bf16 kernel scared frame vs plain frame: {diff}")

    # (d) one request through serve's batch mode, with the checkpoint
    reqs = OUT_DIR / "scared_requests.jsonl"
    out = OUT_DIR / "scared_frame.npz"
    c2w = sc["c2ws"][val_ds.metas[0][1]]
    reqs.write_text(json.dumps({"c2w": np.asarray(c2w).tolist(),
                                "out": str(out)}) + "\n")
    buf = io.StringIO()
    fused_nerf_mlp.launches = 0
    with contextlib.redirect_stdout(buf):
        n = serve.main(["--requests", str(reqs), *SCARED_ARGS,
                        "--ckpt", str(ckpt)])
    serve_launches = fused_nerf_mlp.launches
    serve_summary = json.loads(next(
        ln for ln in buf.getvalue().splitlines()
        if ln.startswith('{"frames"')))
    with np.load(out) as fr:
        frame = {k: fr[k] for k in ("rgb", "depth", "confidence")}
    check(n == 1 and serve_launches == 2 * n_tiles    # + warm-up frame
          and frame["rgb"].shape == (H, W, 3)
          and all(np.isfinite(v).all() for v in frame.values()),
          f"scared serve: {n} frames, {serve_launches} launches, "
          f"{ {k: v.shape for k, v in frame.items()} }")

    jpeg = phase_jpeg()
    res = dict(load=load, steps=len(steps), step_ms=ms,
               steady_ms_per_step=float(np.median(ms[2:])),
               synthetic_steady_ms_per_step=tr["steady_ms_per_step"],
               synthetic_det_cli_ms_per_step=tr["det_steady_ms_per_step"],
               train_wall_s=wall, losses=[ln["loss"] for ln in steps],
               eval_views=val["views"], eval_ms_per_view=val["ms_per_view"],
               eval_wall_s=ev_wall, eval_metrics=metrics,
               k1_launches_eval=eval_launches,
               k1_launches=eval_launches + serve_launches,
               kernel_vs_plain_val_frame=diff,
               serve_ms_per_frame=serve_summary["ms_per_frame"],
               serve_launches=serve_launches, jpeg=jpeg, ckpt=str(ckpt))
    log("scared", **res)
    return res


def rel_to_max(got, want) -> float:
    """Max abs difference over the max abs of ``want``."""
    got, want = (torch.as_tensor(a).float().cpu() for a in (got, want))
    return float((got - want).abs().max() / want.abs().max())


def dpt_work(params, x) -> tuple:
    """(FLOPs, bytes) of one ``dpt_forward`` of ``x``: the FLOPs of its
    convolutions and matrix products from their shapes (torch's
    ``FlopCounterMode``; norms, resizes and activations not counted), the
    bytes of its weights, input and output, each moved once."""
    from torch.utils.flop_counter import FlopCounterMode
    from ucnerf_torch.models import dpt

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        out = dpt.dpt_forward(params, x)
    nbytes = (sum(v.numel() * v.element_size() for v in params.values())
              + x.numel() * x.element_size() + out.numel() * 4)
    return fc.get_total_flops(), nbytes


def convert_seeded_weights() -> dict:
    """(a) Seeded DPT depth, DPT segmentation and LPIPS state dicts under
    their published names, saved with ``torch.save`` and converted through
    ``python -m ucnerf_torch.convert_weights``; each npz read back: the DPT
    ones through the DPT loader equal to the torch files read directly,
    the LPIPS one through ``lpips_weights`` equal to its state dict."""
    from ucnerf_torch import convert_weights
    from ucnerf_torch.eval.lpips import lpips_weights, seeded_lpips_state_dict
    from ucnerf_torch.models import dpt

    depth = dpt.seeded_dpt_state_dict(0)
    sds = {"dpt": depth,
           "dpt_seg": dpt.seeded_dpt_state_dict(0, "seg", shared=depth),
           "lpips": seeded_lpips_state_dict(0)}
    files, secs = {}, {}
    for kind, sd in sds.items():
        src = PRE_DIR / f"{kind}_state.pth"
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
        dst = PRE_DIR / f"{kind}.npz"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            convert_weights.main([kind, str(src), str(dst)])
        secs[kind] = time.perf_counter() - t0
        files[kind] = str(dst)
        if kind == "lpips":
            with np.load(dst) as f:
                w = lpips_weights({k: f[k] for k in f.files})
            check(all(torch.equal(w[f"conv{i}_w"], torch.from_numpy(
                sd[f"net.slice{i + 1}.{cid}.weight"]))
                for i, cid in enumerate((0, 3, 6, 8, 10))),
                "the converted LPIPS kernels are not the state dict's")
            continue
        env = "UCNERF_DPT_WEIGHTS"
        got = dpt._load_converted_params(str(dst), env, "", device="cpu")
        want = dpt._load_converted_params(str(src), env, "", device="cpu")
        check(list(got) == list(sd) and all(torch.equal(got[k], want[k])
                                            for k in sd),
              f"{kind}: the converted npz does not read back as its state "
              f"dict")
    return dict(files=files, convert_s=secs,
                entries={k: len(v) for k, v in sds.items()},
                dpt_parameters=int(sum(v.size for v in depth.values())))


def phase_preprocess(dev, sd: dict) -> dict:
    """Phase preprocess on phase scared's scan (16 frames at 1280x1024):
    (a) ``convert_seeded_weights``; (b) ``python -m
    ucnerf_torch.preprocess dpt`` over every frame in f32 and with
    ``--bf16`` (the net at 384x480), each ``pred`` finite, positive and
    1024x1280 and read back through the SCARED loader's ``_read_dpt``; the
    net alone timed by CUDA events, its FLOPs and bound; (c) on frame 0
    the card's f32 trunk and inverse depth against the port's CPU forward
    of the same weights (DPT_CPU_TOL), and the card's bf16 trunk against
    its f32 trunk (DPT_BF16_TOL); (d) ``preprocess seg`` on SEG_FRAMES
    frames: labels in [1, 150], the PNG equal to ``blend_segmentation`` of
    the frame; (e) ``--eval`` of phase scared's checkpoint with
    ``$UCNERF_LPIPS_WEIGHTS`` set to the converted LPIPS npz: LPIPS
    finite, K1 launches views x tiles; (f) whether a COLMAP binary is
    found, and ``preprocess colmap`` on the scan, whose model exists,
    rewriting ``poses_bounds.npy`` bit for bit."""
    from ucnerf_torch import preprocess
    from ucnerf_torch.config import parse_config
    from ucnerf_torch.data import build_dataset, colmap_wrapper
    from ucnerf_torch.data.image_io import read_frame
    from ucnerf_torch.kernels.fused_mlp import fused_nerf_mlp
    from ucnerf_torch.models import dpt
    from ucnerf_torch.utils.png import read_png
    from ucnerf_torch.utils.viz import blend_segmentation

    scene = SCAN_DIR / "scene0"
    shutil.rmtree(PRE_DIR, ignore_errors=True)
    shutil.rmtree(OUT_DIR / "p_eval", ignore_errors=True)
    PRE_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    weights = convert_seeded_weights()
    weights["seconds"] = time.perf_counter() - t0

    # (b) the DPT prior over the scan, f32 (TF32 off) and bf16
    cfg = parse_config(SCAN_ARGS)
    ds = build_dataset(cfg, "train")
    frames = sorted((scene / "images").glob("*"))
    runs, preds = {}, {}
    for mode, extra in (("f32", []), ("bf16", ["--bf16"])):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = preprocess.main(["dpt", str(scene), "--weights",
                                   weights["files"]["dpt"], *extra])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(out["frames"] == len(frames) == SCAN_FRAMES,
              f"dpt {mode}: {out['frames']} frames of {len(frames)}")
        for p in frames:
            path = scene / "dpt" / f"{p.stem}.npz"
            with np.load(path) as f:
                pred = f["pred"]
            check(pred.shape == SCAN_WH[::-1] and pred.dtype == np.float32
                  and np.isfinite(pred).all() and pred.min() > 0,
                  f"dpt {mode} {path.name}: {pred.shape} {pred.dtype} "
                  f"min {pred.min()}")
            prior = ds._read_dpt(str(path))
            check(prior.shape == ds.img_wh[::-1] and np.isfinite(prior).all()
                  and prior.min() > 0, f"_read_dpt({path.name}): "
                  f"{prior.shape} min {prior.min()}")
            if p == frames[0]:
                preds[mode] = pred
        runs[mode] = dict(
            wall_s=wall, load_s=out["load_s"],
            ms_per_frame=out["ms_per_frame"],
            steady_ms_per_frame=float(np.median(out["ms_per_frame"][1:])),
            scan_s=sum(out["ms_per_frame"]) / 1e3,
            peak_mem_gib=peak / 2 ** 30,
            peak_above_start_gib=(peak - base) / 2 ** 30)

    # the net alone on frame 0's input, its work and its bound
    img01 = np.asarray(read_frame(str(frames[0])), np.float32) / 255.0
    params = {m: dpt._load_converted_params(
        weights["files"]["dpt"], "UCNERF_DPT_WEIGHTS", "",
        dtype=None if m == "f32" else "bfloat16", device=dev)
        for m in ("f32", "bf16")}
    x32, _, net_hw = dpt._net_input(img01, dev, torch.float32, 384)
    xs = {"f32": x32, "bf16": x32.to(torch.bfloat16)}
    net = {}
    with torch.no_grad():
        for m in ("f32", "bf16"):
            flops, nbytes = dpt_work(params[m], xs[m])
            ms = time_ms(lambda: dpt.dpt_forward(params[m], xs[m]), iters=10,
                         warmup=2)
            peak = PEAK_F32 if m == "f32" else PEAK_BF16
            bound = max(flops / peak, nbytes / PEAK_BYTES) * 1e3
            net[m] = dict(ms=ms, flops=flops, bytes=nbytes, bound_ms=bound,
                          bound_by="operations" if flops / peak
                          >= nbytes / PEAK_BYTES else "bytes",
                          tflops=flops / ms / 1e9, bound_share=bound / ms,
                          profile=profile_frame(
                              lambda: dpt.dpt_forward(params[m], xs[m]),
                              top=8, name=f"dpt_{m}_profile.txt"))

        # (c) the card against the port's CPU forward, bf16 against f32
        trunk = dpt._dpt_trunk(params["f32"], x32)
        depth = dpt._depth_head(params["f32"], trunk)
        trunk16 = dpt._dpt_trunk(params["bf16"], xs["bf16"])
        cpu = dpt._load_converted_params(weights["files"]["dpt"],
                                         "UCNERF_DPT_WEIGHTS", "",
                                         device="cpu")
        t0 = time.perf_counter()
        trunk_cpu = dpt._dpt_trunk(cpu, x32.cpu())
        depth_cpu = dpt._depth_head(cpu, trunk_cpu)
        cpu_s = time.perf_counter() - t0
    vs = dict(trunk_card_vs_cpu=rel_to_max(trunk, trunk_cpu),
              depth_card_vs_cpu=rel_to_max(depth, depth_cpu),
              trunk_bf16_vs_f32=rel_to_max(trunk16, trunk),
              written_pred_bf16_vs_f32=rel_to_max(preds["bf16"],
                                                  preds["f32"]),
              cpu_forward_s=cpu_s, net_input_hw=list(net_hw))
    check(vs["trunk_card_vs_cpu"] <= DPT_CPU_TOL
          and vs["depth_card_vs_cpu"] <= DPT_CPU_TOL,
          f"the card's f32 DPT against the CPU's: {vs}")
    check(vs["trunk_bf16_vs_f32"] <= DPT_BF16_TOL,
          f"the card's bf16 DPT trunk against its f32 one: {vs}")
    del params, cpu, trunk, trunk16, trunk_cpu

    # (d) segmentation of SEG_FRAMES frames
    seg_scene = PRE_DIR / "seg_scene"
    (seg_scene / "images").mkdir(parents=True)
    for p in frames[:SEG_FRAMES]:
        shutil.copy(p, seg_scene / "images" / p.name)
    with contextlib.redirect_stdout(io.StringIO()):
        seg_out = preprocess.main(["seg", str(seg_scene), "--weights",
                                   weights["files"]["dpt_seg"]])
    classes = []
    for p in frames[:SEG_FRAMES]:
        with np.load(seg_scene / "seg" / f"{p.stem}.npz") as f:
            labels = f["labels"]
        check(labels.shape == SCAN_WH[::-1] and labels.dtype == np.int32
              and labels.min() >= 1 and labels.max() <= 150,
              f"seg {p.stem}: {labels.shape} {labels.dtype} "
              f"[{labels.min()}, {labels.max()}]")
        img = np.asarray(read_frame(str(p)), np.float32)[..., :3] / 255.0
        png = read_png(str(seg_scene / "seg" / f"{p.stem}.png"))
        check(np.array_equal(png, blend_segmentation(img, labels)),
              f"seg {p.stem}.png is not blend_segmentation of the frame")
        classes.append(int(len(np.unique(labels))))
    seg = dict(frames=seg_out["frames"], load_s=seg_out["load_s"],
               ms_per_frame=seg_out["ms_per_frame"], classes=classes)

    # (e) LPIPS from the converted seeded weights in --eval
    val_ds = build_dataset(cfg, "val")
    W, H = val_ds.img_wh
    n_tiles = -(-W * H // cfg.chunk)
    os.environ["UCNERF_LPIPS_WEIGHTS"] = weights["files"]["lpips"]
    fused_nerf_mlp.launches = 0
    try:
        ev_summary, ev_lines, ev_wall = run_trainer(
            "p_eval", "--eval", "--ckpt", sd["ckpt"], "--val_panels", "none",
            base=SCAN_ARGS)
    finally:
        del os.environ["UCNERF_LPIPS_WEIGHTS"]
    launches = fused_nerf_mlp.launches
    [val] = [ln for ln in ev_lines if "val_step" in ln]
    metrics = ev_summary["val"]
    check(len(metrics) == 10 and np.isfinite(list(metrics.values())).all(),
          f"--eval with converted LPIPS weights: {metrics}")
    check(val["views"] == len(val_ds) and launches == len(val_ds) * n_tiles,
          f"K1 launches {launches} over {val['views']} views, expected "
          f"{len(val_ds)} x {n_tiles}")

    # (f) COLMAP: the binary is optional; the scan's model exists, so only
    # its poses are written (last: a new poses_bounds.npy stales the cache)
    try:
        colmap_bin = colmap_wrapper._colmap_bin()
    except colmap_wrapper.ColmapNotFound:
        colmap_bin = None
    poses = np.load(scene / "poses_bounds.npy")
    with contextlib.redirect_stdout(io.StringIO()):
        preprocess.main(["colmap", str(scene)])
    check(np.array_equal(np.load(scene / "poses_bounds.npy"), poses),
          "preprocess colmap changed the scan's poses_bounds.npy")

    res = dict(weights=weights, colmap_binary=colmap_bin, dpt=runs, net=net,
               card_vs_cpu=vs, seg=seg, eval_metrics=metrics,
               eval_ms_per_view=val["ms_per_view"], eval_wall_s=ev_wall,
               k1_launches=launches)
    log("preprocess", **res)
    return res


def main():
    sys.path.insert(0, str(ROOT))
    try:
        from ucnerf_torch.config import parse_config
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the ucnerf_torch package is missing "
                         f"beside this script ({e})")
    # cuBLAS is deterministic only with a fixed workspace; set before the
    # first cuBLAS call (the trainer's --deterministic runs and the
    # ``deterministic_kernels`` blocks of phase train need it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    cfg = parse_config(SERVE_ARGS)
    phase_build()
    k1 = phase_k1(cfg, dev)
    sv = phase_serving(cfg, dev)
    hp = phase_http(cfg, dev)
    rp = phase_render_path(cfg)
    tr = phase_train(dev)
    try:
        sd = phase_scared(dev, tr)
        pp = phase_preprocess(dev, sd)
    finally:     # the scan, the weights and the checkpoints are large
        shutil.rmtree(SCAN_DIR, ignore_errors=True)
        shutil.rmtree(PRE_DIR, ignore_errors=True)
        for name in ("s_train", "s_eval", "p_eval"):
            shutil.rmtree(OUT_DIR / name / "ckpts", ignore_errors=True)
    record = {"k1": k1, "serving": sv, "http": hp, "render_path": rp,
              "train": tr, "scared": sd, "preprocess": pp, "nvidia_smi": smi,
              "seconds": time.perf_counter() - t_start}
    (OUT_DIR / "result.json").write_text(json.dumps(record, indent=1))
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_nerf_mlp", "route": "cuda",
        "source": "ucnerf_torch/csrc/fused_mlp.cu",
        "replaces": "ucnerf_tpu/pallas/mlp_kernel.py:115",
        "launches": (sv["launches"] + hp["launches"] + rp["launches"]
                     + tr["k1_launches"] + sd["k1_launches"]
                     + pp["k1_launches"]),
        "max_abs_err": k1["serving"]["bf16_vs_plain_bf16_max_abs_err"],
        "ms": k1["bf16_ms"], "plain_ms": k1["plain_bf16_ms"],
        "bound_ms": k1["bound_bf16_ms"], "bound_by": k1["bound_by_bf16"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
