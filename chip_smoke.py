"""Smoke test of ucnerf_torch on one CUDA card: builds the port's kernels,
holds each against its plain PyTorch version, serves novel views at the
SCARED operating point through ``python -m ucnerf_torch.serve``'s batch
and HTTP modes, renders a trajectory through ``python -m
ucnerf_torch.render_path``, and trains at the SCARED train point through
``python -m ucnerf_torch.train``'s entry point: a run stopped at a
checkpoint, its resume against an uninterrupted run (both with
``--deterministic``), ``--eval`` of the checkpoint over the whole val split
with ``--val_panels all``, the device scene store against host loading,
an overfit of one sample, and steps at an odd ``--patch_num`` (card
against CPU, and the trainer's).  Phase ``options`` runs the cascade's and
the renderer's options at the train point: ``--mvs_dtype bfloat16`` (its
cascade against float32, trainer steps, the FeatureNet's weight gradients
profiled in both dtypes, a ``--deterministic`` step run twice, bit for
bit), the literal featurization (its feature tensor against the fast one,
trainer steps, two ``--deterministic`` steps run twice, ``--eval`` on K1),
``--use_color_volume`` (a served frame against the exact one, ms per frame
at 48 and 64 planes, the volume's build time and memory) and
``--encode_a`` (the table bit for bit after Adam's steps), K1 against the
plain MLP on the new renders.  Phase ``scared`` fabricates a
SCARED-layout scan at 1280x1024 with the port's own writers, loads it cold
and warm through the scene cache, trains 12 steps on it through ``python
-m ucnerf_torch.train --dataset_name scared``, evaluates the checkpoint
over its val split on K1, serves one request from it, and decodes the
committed JPEG fixtures to their recorded digests.  Phase ``preprocess``
converts seeded DPT-Hybrid and LPIPS weights through ``python -m
ucnerf_torch.convert_weights``, runs ``python -m ucnerf_torch.preprocess
dpt`` over that scan in f32 and bf16 and ``seg`` on two of its frames,
holds the card's DPT against its CPU forward, and evaluates the scan's
checkpoint with the converted LPIPS weights.  Phase ``mesh`` runs the
multi-rank port (``ucnerf_torch/parallel``) through the entry points on
ranks that share the one card (gloo): the collectives forward and
backward on a one-rank NCCL group; every step of 2-rank ray-DP
(plain, an odd ray count, ``--shard_mvs_views``), 2-rank scene-DP and
the 2x2 grid on 4 ranks against the serial step at the same weights,
the trainer's runs of the three modes, a ray-DP resume bit for bit,
a 2-rank ``--eval`` against one device's view by view, ``serve`` in
batch and HTTP mode and ``render_path`` on 2 ranks.  Which parts of a
train
step vary run to run on the card's default kernels is measured on demand
by ``scripts/determinism_probe.py``, the DPT forward's backend settings
by ``scripts/dpt_probe.py``.

    python3 chip_smoke.py

Phases (one line each): device, build, k1 (K1 vs plain), serving, http,
render_path, resume, panels, store_vs_host, train, options (four lines),
scared, preprocess, mesh, then the seconds of each.
Any failed check raises, so the script exits non-zero and prints no
result.  Before the last line it prints the card's ``nvidia-smi`` name and
power limit and one JSON line with every kernel of the main path (K1's
launches summed over serving, HTTP, render_path, the eval, phase options'
literal ``--eval`` and colour-volume request, phase scared's eval and
request, phase preprocess's eval, and every rank's launches in phase
mesh); the last line is
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
# phase options: trainer steps per option, the --deterministic pairs' steps
# of the literal featurization, and --encode_a's steps
OPT_STEPS = 12
OPT_DET_STEPS = 2
ENCODE_STEPS = 4
# (a) the bf16 cascade against f32 on val sample 0 of the serving scene
# (320x256, V=7, the weights of --seed): its bound is twice the JAX
# package's own bf16-vs-f32 gap on the same inputs and weights, measured
# once on a CPU by scripts/jax_option_gaps.py (jax 0.9.0, XLA CPU, the
# convolutions' outputs rounded to bf16 as the program says)
CASCADE_BF16_GAP = dict(depth_mean_rel=0.002029495988901919,
                        confidence_max_abs=0.6748963594436646)
# (b) literal against fast features: tests/test_fast_feats.py:57-60's
# bound, FEAT_TOL[0] * max|literal| + FEAT_TOL[1]
FEAT_TOL = (2e-3, 1e-4)
# (c) the 64-plane colour-volume frame against the exact one, mean abs of
# rgb and depth: tests/test_color_volume.py:30-35's bound.  The JAX
# package's own approximation keeps inside it at 320x256 on the same scene,
# weights and pose (rgb 8.4e-4, depth 1.9e-3, scripts/jax_option_gaps.py)
COLOR_VOLUME_TOL = (0.02, 0.05)
COLOR_VOLUME_TOL_SOURCE = ("tests/test_color_volume.py:30-35 (the JAX "
                           "package at 320x256: rgb 8.4e-4, depth 1.9e-3)")
# the CPU parity tests' small shape (tests/test_torch_train.py)
SMALL_ARGS = ["--dataset_name", "synthetic", "--view_num", "4", "--N_samples",
              "9", "--batch_size", "80", "--patch_size", "4", "--patch_num",
              "4", "--n_depth_rays", "32", "--chunk", "256", "--num_epochs",
              "4", "--lrate", "5e-4", "--ndepths", "8", "8", "8",
              "--nerf_dtype", "float32"]


# an odd --patch_num: at SMALL_ARGS (card vs CPU) and at the train point
ODD_PATCH_NUM = (5, 25)


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
    decoder and the COLMAP loader with the host compiler."""
    from concurrent.futures import ThreadPoolExecutor
    from ucnerf_torch.kernels import build
    t0 = time.perf_counter()
    names = ("fused_mlp", "jpeg_decode", "colmap_fast")
    with ThreadPoolExecutor(len(names)) as pool:
        res = dict(zip(names, pool.map(build.build, names)))
    log("build", kernel="fused_mlp", seconds=time.perf_counter() - t0,
        nvcc_seconds=res["fused_mlp"]["seconds"],
        cxx_seconds=res["jpeg_decode"]["seconds"],
        colmap_cxx_seconds=res["colmap_fast"]["seconds"],
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


def card_vs_cpu_step(dev, extra=()) -> dict:
    """One loss and its gradients at the CPU tests' small shape (and the
    flags ``extra``), with the same weights and the same draws, on the
    card and on the CPU (float32, TF32 off)."""
    from ucnerf_torch.config import parse_config
    from ucnerf_torch.data import build_dataset
    from ucnerf_torch.models.factory import create_models, init_params
    from ucnerf_torch.ops.rays import TrainDraws, draw_train_randomness
    from ucnerf_torch.render.serving import to_device_batch
    from ucnerf_torch.train.loop import scene_loss

    cfg = parse_config([*SMALL_ARGS, *extra])
    sample = build_dataset(cfg, "train")[0]
    H, W = sample["images"].shape[1:3]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    draws = draw_train_randomness(
        torch.Generator().manual_seed(1), H=H, W=W,
        patch_size=cfg.patch_size, patch_num=cfg.patch_num,
        n_uniform=cfg.n_uniform_rays, n_rays=cfg.n_built_rays,
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
            n_uniform=cfg.n_uniform_rays, n_rays=cfg.n_built_rays,
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
    step on deterministic kernels, one small-shape step on the card vs
    the CPU, again at an odd ``--patch_num``, and two trainer steps at an
    odd ``--patch_num`` at the train point."""
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
                   n_rays=cfg.n_built_rays, n_samples=cfg.N_samples)
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
    # an odd --patch_num: the batch holds one patch fewer than
    # n_train_rays counts (tests/test_torch_train_patch_odd.py)
    cc_odd = card_vs_cpu_step(dev, ["--patch_num", str(ODD_PATCH_NUM[0])])
    for c in (cc, cc_odd):
        check(abs(c["loss_rel"]) <= 1e-4 and c["grads"]["median"] < 5e-3
              and c["grads"]["worst"] < 3e-2,
              f"card vs CPU loss/gradients out of bounds: {c}")
    shutil.rmtree(OUT_DIR / "odd_patch", ignore_errors=True)
    odd, odd_lines, _ = run_trainer("odd_patch", "--patch_num",
                                    str(ODD_PATCH_NUM[1]),
                                    "--stop_after_steps", "2")
    shutil.rmtree(OUT_DIR / "odd_patch", ignore_errors=True)
    ocfg = parse_config([*TRAIN_ARGS, "--patch_num", str(ODD_PATCH_NUM[1])])
    odd_steps = step_lines(odd_lines)
    check(len(odd_steps) == 2
          and all(np.isfinite(ln["loss"]) for ln in odd_steps)
          and ocfg.n_built_rays < ocfg.n_train_rays
          and abs(odd["rays_per_s"] / (ocfg.n_built_rays
                                       / odd["median_step_ms"] * 1e3) - 1)
          < 1e-9, f"odd --patch_num steps: {odd_steps}, {odd}")

    overfit_ms_median = float(np.median(overfit_ms[2:]))
    res = dict(steps=len(steps), step_ms=ms,
               # the CLI runs, on deterministic kernels
               det_steady_ms_per_step=steady_ms,
               det_host_fed_steady_ms_per_step=resume["whole_steady_ms"],
               rays_per_step=cfg.n_built_rays,
               # the step on the card's default kernels (the overfit loop)
               steady_ms_per_step=overfit_ms_median,
               det_kernels_ms_per_step=float(np.median(det_ms[2:])),
               train_rays_per_s=cfg.n_built_rays / overfit_ms_median * 1e3,
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
               card_vs_cpu=cc, card_vs_cpu_odd_patch_num=cc_odd,
               odd_patch_num=dict(patch_num=ODD_PATCH_NUM[1],
                                  rays=ocfg.n_built_rays,
                                  losses=[ln["loss"] for ln in odd_steps],
                                  median_step_ms=odd["median_step_ms"]))
    log("train", **res)
    return res

def cli_pair_bitwise(name: str, argv: list) -> dict:
    """Two identical ``ucnerf_torch.train`` runs of ``argv`` that stop at a
    checkpoint: whether every step line's loss terms and LR and every
    checkpointed weight are equal bit for bit."""
    runs = []
    for i in (1, 2):
        shutil.rmtree(OUT_DIR / f"{name}{i}", ignore_errors=True)
        summary, lines, _ = run_trainer(f"{name}{i}", *argv)
        with np.load(os.path.join(summary["ckpt"], "params.npz")) as f:
            runs.append((step_lines(lines), {k: f[k] for k in f.files}))
        shutil.rmtree(OUT_DIR / f"{name}{i}" / "ckpts", ignore_errors=True)
    (s1, p1), (s2, p2) = runs
    keys = ("loss", "img_mse", "nerf_depth", "mvs", "smooth", "scaleinv",
            "lr")
    unequal = sorted(k for k in p1 if not np.array_equal(p1[k], p2[k]))
    return dict(steps=len(s1), losses=[ln["loss"] for ln in s1],
                lines_equal=len(s1) == len(s2) > 0 and all(
                    a[k] == b[k] for a, b in zip(s1, s2) for k in keys),
                unequal_params=unequal, params=len(p1))


def wgrad_ms(profile_name: str) -> dict:
    """Device ms of the weight-gradient kernels in a profile table that
    ``profile_frame`` wrote (cuDNN and CUTLASS name them ``wgrad``)."""
    rows = {}
    for ln in (OUT_DIR / profile_name).read_text().splitlines():
        ms, _, rest = ln.strip().partition(" ms ")
        name = rest.split("x  ", 1)[-1]
        if "wgrad" in name.lower():
            rows[name[:100]] = rows.get(name[:100], 0.0) + float(ms)
    return dict(total_ms=sum(rows.values()), kernels=rows)


def phase_options(dev, tr: dict, sv: dict) -> dict:
    """The cascade's and the renderer's options at the train point (TF32
    off): (a) ``--mvs_dtype bfloat16``: one view's cascade against float32
    within twice the JAX package's own gap (CASCADE_BF16_GAP), OPT_STEPS
    trainer steps, the FeatureNet's weight gradients profiled in both
    dtypes and one bf16 step profiled, and a ``--deterministic`` step run
    twice; (b) ``fast_featurization`` false: the literal feature tensor of
    one training batch against the fast one (FEAT_TOL), OPT_STEPS trainer
    steps, two ``--deterministic`` steps run twice, ``--eval`` on K1 and
    K1 against the plain MLP on the literal features; (c)
    ``--use_color_volume --color_volume_depths 64``: one frame through
    ``ucnerf_torch.serve`` against phase serving's exact frame of the same
    pose (COLOR_VOLUME_TOL), steady ms/frame at 48 and 64 planes, the
    volume's build time, peak memory, K1 against the plain MLP on that
    frame; (d) ``--encode_a``: ENCODE_STEPS steps, the table bit for bit
    its drawn value in the checkpoint."""
    from ucnerf_torch import serve
    from ucnerf_torch.config import parse_config
    from ucnerf_torch.data import build_dataset
    from ucnerf_torch.kernels.fused_mlp import fused_nerf_mlp
    from ucnerf_torch.models.factory import create_models, init_params
    from ucnerf_torch.ops.rays import draw_train_randomness
    from ucnerf_torch.render.fast_feats import (build_color_volumes,
                                                gen_pts_feats_fast)
    from ucnerf_torch.render.renderer import gen_pts_feats, make_feat_ctx
    from ucnerf_torch.render.serving import to_device_batch
    from ucnerf_torch.train.loop import (TrainState, make_lr_schedule,
                                         make_optimizer, make_train_step,
                                         run_mvs, scene_inputs, unnormalize)
    from ucnerf_torch.utils.checkpoint_io import load_params_npz

    cfg = parse_config(TRAIN_ARGS)
    W, H = cfg.img_wh
    n_tiles = -(-W * H // cfg.chunk)
    params = init_params(cfg, torch.Generator().manual_seed(cfg.seed), dev)
    lit_json = OUT_DIR / "literal.json"
    lit_json.write_text(json.dumps({"fast_featurization": False}))
    res = {}
    fused_nerf_mlp.launches = 0

    # (a) the bf16 cascade on val sample 0 of the serving scene
    val = to_device_batch(build_dataset(cfg, "val")[0], dev)
    casc, casc_ms = {}, {}
    for dt in ("float32", "bfloat16"):
        _, mvs = create_models(cfg.replace(mvs_dtype=dt), dev, params)
        with torch.no_grad():
            casc[dt] = run_mvs(cfg, mvs, val)["stage3"]
            casc_ms[dt] = time_ms(lambda: run_mvs(cfg, mvs, val), iters=5,
                                  warmup=1)
    d32, d16 = casc["float32"]["depth"], casc["bfloat16"]["depth"]
    c32 = casc["float32"]["photometric_confidence"]
    c16 = casc["bfloat16"]["photometric_confidence"]
    gap = dict(depth_mean_rel=((d16 - d32).abs() / d32.abs()).mean().item(),
               confidence_max_abs=(c16 - c32).abs().max().item(),
               confidence_mean_abs=(c16 - c32).abs().mean().item())
    check(gap["depth_mean_rel"] <= 2 * CASCADE_BF16_GAP["depth_mean_rel"]
          and gap["confidence_max_abs"]
          <= 2 * CASCADE_BF16_GAP["confidence_max_abs"],
          f"bf16 cascade vs f32 beyond twice the JAX package's gap "
          f"{CASCADE_BF16_GAP}: {gap}")
    summary, lines, _ = run_trainer("o_bf16", "--mvs_dtype", "bfloat16",
                                    "--stop_after_steps", str(OPT_STEPS))
    bf16_steps = step_lines(lines)
    check(len(bf16_steps) == OPT_STEPS and all(
        np.isfinite(ln["loss"]) for ln in bf16_steps),
        f"bf16 cascade steps: {bf16_steps}")
    # the FeatureNet alone, forward + backward over the train sample's
    # source views, in each dtype, its output gradients laid out as the
    # step's gathers give them (contiguous channel-last, so NCHW with
    # channels-last strides) and as plain NCHW; then one whole bf16 step
    with bench_scene():
        batch = to_device_batch(build_dataset(cfg, "train")[0], dev)
    featnet = {}
    for dt in ("float32", "bfloat16"):
        _, mvs = create_models(cfg.replace(mvs_dtype=dt), dev, params)
        shapes = {k: v.shape for k, v in
                  mvs.features(batch["images"][1:]).items()}
        for layout in ("channels_last", "nchw"):
            grads = [torch.randn(s, device=dev) if layout == "channels_last"
                     else torch.randn((s[0], s[3], s[1], s[2]), device=dev)
                     .permute(0, 2, 3, 1) for s in shapes.values()]

            def fwd_bwd():
                out = mvs.features(batch["images"][1:])
                torch.autograd.backward([out[k] for k in shapes], grads)
            fwd_bwd()
            name = f"featurenet_{dt}_{layout}_profile.txt"
            prof = profile_frame(fwd_bwd, name=name)
            featnet[f"{dt}_{layout}"] = dict(
                device_busy_ms=prof["device_busy_ms"], wgrad=wgrad_ms(name))
    # the CostRegNets alone, forward + backward at each stage's input
    # shape at the train point, and their probability convolutions (one
    # output channel, float32 in either dtype) alone
    vol_shapes = [(1, c, d, H // s, W // s) for c, d, s in
                  zip((32, 16, 8), cfg.ndepths, (4, 2, 1))]
    costreg = {}
    for dt in ("float32", "bfloat16"):
        _, mvs = create_models(cfg.replace(mvs_dtype=dt), dev, params)
        nets = mvs.cost_regularization
        vols = [torch.randn(sh, device=dev, requires_grad=True)
                for sh in vol_shapes]
        costs = [torch.randn((1, 8) + sh[2:], device=dev,
                             requires_grad=True) for sh in vol_shapes]
        runs = {"costreg": lambda: sum(
                    c.square().mean() + p.square().mean() for c, p in
                    (net(v) for net, v in zip(nets, vols))).backward(),
                "prob": lambda: sum(
                    net.prob(c).square().mean()
                    for net, c in zip(nets, costs)).backward()}
        for part, run in runs.items():
            run()
            name = f"{part}_{dt}_profile.txt"
            prof = profile_frame(run, name=name)
            costreg[f"{part}_{dt}"] = dict(
                device_busy_ms=prof["device_busy_ms"], wgrad=wgrad_ms(name))
    bcfg = cfg.replace(mvs_dtype="bfloat16")
    nerf, mvs = create_models(bcfg, dev, params)
    state = TrainState(nerf, mvs, make_optimizer(bcfg, nerf, mvs))
    step = make_train_step(bcfg, make_lr_schedule(bcfg, 10))
    draws = draw_train_randomness(
        torch.Generator(device=dev).manual_seed(1), H=H, W=W,
        patch_size=cfg.patch_size, patch_num=cfg.patch_num,
        n_uniform=cfg.n_uniform_rays, n_rays=cfg.n_built_rays,
        n_samples=cfg.N_samples)
    for _ in range(3):
        step(state, batch, draws)
    bf16_profile = profile_frame(lambda: step(state, batch, draws),
                                 name="train_bf16_profile.txt")
    det = cli_pair_bitwise("o_bf16_det", [
        "--mvs_dtype", "bfloat16", "--deterministic", "--stop_after_steps",
        "1"])
    res["bf16"] = dict(
        cascade_vs_f32=gap, jax_gap=CASCADE_BF16_GAP,
        cascade_ms=casc_ms, step_ms=[ln["ms"] for ln in bf16_steps],
        steady_ms_per_step=float(np.median(
            [ln["ms"] for ln in bf16_steps[2:]])),
        f32_steady_ms_per_step=tr["steady_ms_per_step"],
        f32_step_profile=tr["step_profile"],
        f32_step_wgrad=wgrad_ms("train_profile.txt"),
        featurenet=featnet, costreg=costreg, step_profile=bf16_profile,
        step_wgrad=wgrad_ms("train_bf16_profile.txt"), deterministic=det)
    log("options_bf16", **res["bf16"])
    check(det["lines_equal"] and not det["unequal_params"],
          f"--deterministic bf16 step not bit for bit: {det}")

    # (b) the literal featurization
    lcfg = cfg.replace(fast_featurization=False)
    _, mvs = create_models(lcfg, dev, params)
    with torch.no_grad():
        draws = draw_train_randomness(
            torch.Generator(device=dev).manual_seed(2), H=H, W=W,
            patch_size=cfg.patch_size, patch_num=cfg.patch_num,
            n_uniform=cfg.n_uniform_rays, n_rays=cfg.n_built_rays,
            n_samples=cfg.N_samples)
        imgs, mvs_out, conf, rays = scene_inputs(lcfg, mvs, batch, draws)
        ctx = make_feat_ctx(mvs_out, conf, imgs[1:], batch["w2cs"][1:],
                            batch["intrinsics"][1:])
        lit = gen_pts_feats(rays, ctx)
        fast = gen_pts_feats_fast(rays, ctx["stage_volumes"], conf,
                                  ctx["views"], ctx["src_w2cs"],
                                  ctx["src_intrinsics"], (H, W))
    v1 = cfg.view_num - 1
    masks = slice(24 + 3, 24 + 4 * v1, 4)
    feats = dict(shape=list(lit.shape),
                 max_abs=(lit - fast).abs().max().item(),
                 bound=FEAT_TOL[0] * lit.abs().max().item() + FEAT_TOL[1],
                 mask_agreement=(lit[..., masks] == fast[..., masks])
                 .float().mean().item())
    check(feats["max_abs"] <= feats["bound"] and feats["mask_agreement"]
          > 0.999, f"literal vs fast features: {feats}")
    summary, lines, _ = run_trainer("o_lit", "--config", str(lit_json),
                                    "--stop_after_steps", str(OPT_STEPS))
    lit_steps = step_lines(lines)
    check(len(lit_steps) == OPT_STEPS and all(
        np.isfinite(ln["loss"]) for ln in lit_steps),
        f"literal featurization steps: {lit_steps}")
    lit_det = cli_pair_bitwise("o_lit_det", [
        "--config", str(lit_json), "--deterministic", "--stop_after_steps",
        str(OPT_DET_STEPS)])
    check(lit_det["lines_equal"] and not lit_det["unequal_params"]
          and lit_det["steps"] == OPT_DET_STEPS,
          f"--deterministic literal steps not bit for bit: {lit_det}")
    with bench_scene():
        n_val = len(build_dataset(cfg, "val"))
    before = fused_nerf_mlp.launches
    ev_summary, ev_lines, _ = run_trainer(
        "o_lit_eval", "--config", str(lit_json), "--eval", "--val_panels",
        "none")
    [ev] = [ln for ln in ev_lines if "val_step" in ln]
    lit_launches = fused_nerf_mlp.launches - before
    check(lit_launches == n_val * n_tiles and np.isfinite(
        [v for k, v in ev_summary["val"].items() if k != "lpips"]).all(),
        f"literal --eval: {lit_launches} K1 launches, {ev_summary['val']}")
    launches = fused_nerf_mlp.launches
    lit_k1, _ = kernel_vs_plain_frame(lcfg, params, val, (H, W), dev)
    fused_nerf_mlp.launches = launches   # comparison launches do not count
    check(lit_k1["rgb_mean_abs"] <= 5e-3 and lit_k1["depth_mean_rel"]
          <= 5e-3, f"K1 vs plain on the literal features: {lit_k1}")
    res["literal"] = dict(
        features=feats, step_ms=[ln["ms"] for ln in lit_steps],
        steady_ms_per_step=float(np.median(
            [ln["ms"] for ln in lit_steps[2:]])),
        deterministic=lit_det, eval_views=ev["views"],
        eval_ms_per_view=ev["ms_per_view"], eval_metrics=ev_summary["val"],
        k1_launches=lit_launches, kernel_vs_plain=lit_k1)
    log("options_literal", **res["literal"])

    # (c) the colour volume: one served frame of phase serving's pose 0
    c2w = json.loads((OUT_DIR / "requests.jsonl").read_text()
                     .splitlines()[0])["c2w"]
    reqs = OUT_DIR / "cv_request.jsonl"
    out = OUT_DIR / "cv_frame.npz"
    reqs.write_text(json.dumps({"c2w": c2w, "out": str(out)}) + "\n")
    cv_args = [*SERVE_ARGS, "--use_color_volume", "--color_volume_depths"]
    before = fused_nerf_mlp.launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        n = serve.main(["--requests", str(reqs), *cv_args, "64"])
    cv_launches = fused_nerf_mlp.launches - before
    check(n == 1 and cv_launches == 2 * n_tiles,   # + the warm-up frame
          f"colour-volume serve: {n} frames, {cv_launches} K1 launches")
    with np.load(out) as f, np.load(OUT_DIR / "frame_000.npz") as g:
        vs_exact = frame_diff([f[k] for k in FRAME_KEYS],
                              [g[k] for k in FRAME_KEYS])
    check(vs_exact["rgb_mean_abs"] < COLOR_VOLUME_TOL[0]
          and vs_exact["depth_mean_abs"] < COLOR_VOLUME_TOL[1],
          f"colour-volume frame vs exact beyond {COLOR_VOLUME_TOL}: "
          f"{vs_exact}")
    cv = {}
    pose = np.asarray(c2w, np.float32)
    for planes in (48, 64):
        ccfg = parse_config([*cv_args, str(planes)])
        renderer, _ = serve.build_renderer(ccfg)
        fb = renderer.frame_batch(pose)
        with torch.no_grad():
            views = torch.cat([unnormalize(fb["images"][1:]),
                               renderer.src_feats["stage3"]], dim=-1)
            near, far = fb["near_fars"][0, 0], fb["near_fars"][0, 1]
            build_ms = time_ms(lambda: build_color_volumes(
                views, fb["w2cs"][1:], fb["intrinsics"][1:], fb["c2ws"][0],
                fb["intrinsics"][0], near, far, planes), iters=3, warmup=1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            frame_ms = time_ms(lambda: renderer.render(pose), iters=3,
                               warmup=1)
            peak = torch.cuda.max_memory_allocated() - base
        cv[planes] = dict(steady_ms_per_frame=frame_ms,
                          volume_build_ms=build_ms,
                          peak_mem_gib_above_start=peak / 2 ** 30,
                          volume_gib=v1 * W * H * planes
                          * (views.shape[-1] + 1) * 4 / 2 ** 30)
    launches = fused_nerf_mlp.launches
    cv_k1, _ = kernel_vs_plain_frame(cfg.replace(use_color_volume=True,
                                                 color_volume_depths=64),
                                     serve.load_params(cfg, dev),
                                     renderer.frame_batch(pose), (H, W), dev)
    fused_nerf_mlp.launches = launches   # comparison launches do not count
    check(cv_k1["rgb_mean_abs"] <= 5e-3 and cv_k1["depth_mean_rel"] <= 5e-3,
          f"K1 vs plain on the colour-volume frame: {cv_k1}")
    res["color_volume"] = dict(
        vs_exact=vs_exact, bound=COLOR_VOLUME_TOL,
        bound_source=COLOR_VOLUME_TOL_SOURCE, k1_launches=cv_launches,
        exact_steady_ms_per_frame=sv["steady_ms_per_frame"],
        by_planes=cv, kernel_vs_plain=cv_k1)
    log("options_color_volume", **res["color_volume"])

    # (d) --encode_a: Adam leaves the table as it was drawn
    summary, lines, _ = run_trainer("o_enc", "--encode_a",
                                    "--stop_after_steps", str(ENCODE_STEPS))
    table = load_params_npz(os.path.join(summary["ckpt"],
                                         "params.npz"))["appearance"]
    drawn = init_params(cfg.replace(encode_a=True), torch.Generator()
                        .manual_seed(cfg.seed), "cpu")["appearance"].numpy()
    enc_steps = step_lines(lines)
    res["encode_a"] = dict(steps=len(enc_steps),
                           losses=[ln["loss"] for ln in enc_steps],
                           table_shape=list(table.shape),
                           table_bitwise=bool(np.array_equal(table, drawn)))
    shutil.rmtree(OUT_DIR / "o_enc" / "ckpts", ignore_errors=True)
    log("options_encode_a", **res["encode_a"])
    check(res["encode_a"]["table_bitwise"] and len(enc_steps) == ENCODE_STEPS
          and np.isfinite(res["encode_a"]["losses"]).all(),
          f"--encode_a: {res['encode_a']}")
    for name in ("o_bf16", "o_lit", "o_lit_eval"):
        shutil.rmtree(OUT_DIR / name / "ckpts", ignore_errors=True)
    res["k1_launches"] = lit_launches + cv_launches
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


SPARSE_KEYS = ("depth_img", "weight_img", "coords", "depths", "weights")


def fabricate_colmap_model(scene: Path, n_images: int = 300,
                           n_points: int = 100_000,
                           obs_per_image: int = 4000, seed: int = 7) -> dict:
    """A COLMAP model of a long endoscopic sequence's scale at SCARED's
    1280x1024, as the JAX package's ``scripts/bench_native_colmap.py``
    fabricates one: ``n_points`` points in a box 2-5 units in front of
    ``n_images`` cameras that pan along x, ``obs_per_image`` of the points
    in view observed by each image, 30% of them unmatched (id -1); written
    to ``scene/sparse/0`` with the port's writers."""
    from ucnerf_torch.data import colmap
    rng = np.random.default_rng(seed)
    W, H = SCAN_WH
    xyz = rng.uniform([-1, -1, 2.0], [1, 1, 5.0], size=(n_points, 3))
    errs = rng.uniform(0.2, 2.0, size=n_points)
    empty = np.array([], np.int32)
    points = {i + 1: colmap.Point3D(i + 1, xyz[i], np.array([128] * 3),
                                    float(errs[i]), empty, empty)
              for i in range(n_points)}
    images = {}
    for i in range(1, n_images + 1):
        a = 0.002 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        t = np.array([0.02 * i, 0.0, 0.0])
        pc = xyz @ R.T + t
        uv = pc[:, :2] / pc[:, 2:3] * 1000.0 + [W / 2, H / 2]
        seen = np.flatnonzero((pc[:, 2] > 0.1) & (uv[:, 0] >= 0)
                              & (uv[:, 0] < W) & (uv[:, 1] >= 0)
                              & (uv[:, 1] < H))
        sel = np.sort(rng.choice(seen, size=min(obs_per_image, len(seen)),
                                 replace=False))
        ids = (sel + 1).astype(np.int64)
        ids[rng.uniform(size=len(ids)) < 0.3] = -1
        images[i] = colmap.Image(i, colmap.rotmat2qvec(R), t, 1,
                                 f"img_{i:04d}.png", uv[sel], ids)
    sparse = scene / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    colmap.write_cameras_binary({1: colmap.Camera(
        1, "PINHOLE", W, H, np.array([1000.0, 1000.0, W / 2, H / 2]))},
        sparse / "cameras.bin")
    colmap.write_images_binary(images, sparse / "images.bin")
    colmap.write_points3d_binary(points, sparse / "points3D.bin")
    return dict(images=n_images, points=n_points,
                observations=int(sum(len(im.point3D_ids)
                                     for im in images.values())),
                mb=sum(f.stat().st_size for f in sparse.iterdir()) / 1e6)


def sparse_differences(got: list, want: list) -> dict:
    """Per-entry comparison of two sparse-depth loads: names, the values
    of each array that differ, and the largest difference in float32
    units in the last place."""
    names = [e["name"] for e in got] == [e["name"] for e in want]
    n_diff, max_ulp = 0, 0
    for a, b in zip(got, want):
        for k in SPARSE_KEYS:
            if a[k].shape != b[k].shape or a[k].dtype != b[k].dtype:
                return dict(names=names, shapes_equal=False)
            n_diff += int((a[k] != b[k]).sum())
            if a[k].dtype == np.float32 and a[k].size:
                ulp = np.abs(a[k].view(np.int32).astype(np.int64)
                             - b[k].view(np.int32).astype(np.int64))
                max_ulp = max(max_ulp, int(ulp.max()))
    return dict(names=names, shapes_equal=len(got) == len(want),
                values_differing=n_diff, max_ulp=max_ulp)


def native_colmap(scene: Path, ds) -> dict:
    """The native COLMAP loader (``data/native.py``) against the Python
    one (host clock, median of 3): the scan's model, bit for bit, at the
    dataset's splat size; then a large fabricated model
    (``fabricate_colmap_model``) splatted at 320x256, each loader once
    and the native one again, bit for bit the Python loader's."""
    from ucnerf_torch.data import native
    from ucnerf_torch.data.base import load_colmap_sparse_depth
    from ucnerf_torch.data.llff import load_poses_bounds

    def timed_loads(path, args, reps):
        out, times = {}, {"python": [], "native": []}
        for _ in range(reps):
            for name, fn in (("python", load_colmap_sparse_depth),
                             ("native",
                              native.load_colmap_sparse_depth_native)):
                t0 = time.perf_counter()
                out[name] = fn(str(path), *args)
                times[name].append(time.perf_counter() - t0)
        return out, {f"{k}_s": float(np.median(v)) for k, v in
                     times.items()}

    _, bds = load_poses_bounds(str(scene / "poses_bounds.npy"))
    out, scan_s = timed_loads(scene, (ds.img_wh, 1.0 / ds.downsample, bds),
                              3)
    scan = dict(sparse_differences(out["native"], out["python"]), **scan_s,
                splatted=sum(len(e["coords"]) for e in out["python"]))
    check(scan["names"] and scan["shapes_equal"]
          and scan["values_differing"] == 0,
          f"native COLMAP loader vs Python on the scan: {scan}")
    big = OUT_DIR.parent / "colmap_large"
    shutil.rmtree(big, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        made = fabricate_colmap_model(big)
        fabricate_s = time.perf_counter() - t0
        out, big_s = timed_loads(big, ((320, 256), 4.0,
                                       np.array([2.0, 5.0])), 1)
        t0 = time.perf_counter()
        again = native.load_colmap_sparse_depth_native(
            str(big), (320, 256), 4.0, np.array([2.0, 5.0]))
        big_s["native_again_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(big, ignore_errors=True)
    large = dict(sparse_differences(out["native"], out["python"]), **big_s,
                 **made, fabricate_s=fabricate_s,
                 splatted=sum(len(e["coords"]) for e in out["python"]),
                 native_again_equal=sparse_differences(
                     again, out["native"])["values_differing"] == 0)
    check(large["names"] and large["shapes_equal"]
          and large["values_differing"] == 0
          and large["native_again_equal"],
          f"native COLMAP loader vs Python on the large model: {large}")
    return dict(scan=scan, large=large)


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
    fixtures on the card's machine; (f) the scan's sparse depth through
    the native COLMAP loader, bit for bit the Python loader's, and both
    loaders' times there and on a large fabricated model
    (``native_colmap``)."""
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
    colmap_native = native_colmap(SCAN_DIR / "scene0", cold)
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
               serve_launches=serve_launches, jpeg=jpeg,
               colmap_native=colmap_native, ckpt=str(ckpt))
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


# ----------------------------------------------------------- phase mesh
# every mode on ranks that share the one card (gloo), and the collectives
# on a one-rank NCCL group; at the train point on the serving scene (the
# registry's synthetic scene: spawned ranks do not see bench_scene)
MESH_ARGS = [*SERVE_ARGS, *TRAIN_POINT]
MESH_STEPS = 4
MESH_GRID_STEPS = 2
MESH_RESUME_STOP = 2
MESH_TIMEOUT = 300          # s for each set of spawned ranks
MESH_FRAMES = 4             # render_path's frames on the mesh
# each multi-rank step against the serial step at the same weights,
# scenes and draws: ray-DP's loss (rel); the view split, scene-DP and the
# grid reorder sums, so the JAX package's own bound for them
# (tests/test_parallel_views.py, test_parallel.py, test_parallel_grid.py);
# each gradient tensor's max abs difference over its max abs
# (test_parallel.py::test_scene_dp_8dev_grads_match_vmap_serial)
MESH_RAY_LOSS_RTOL = 1e-5
MESH_SCENE_LOSS_RTOL = 1e-4
MESH_GRAD_RTOL = 1e-1
# the per-step cases: (name, flags, steps)
MESH_CASES = (("rays", [], MESH_STEPS),
              ("rays_odd", ["--batch_size", "2001"], MESH_STEPS),
              ("views", ["--shard_mvs_views"], MESH_STEPS),
              ("scenes", ["--parallel_mode", "scenes"], MESH_STEPS))
MESH_GRID = ["--mesh_shape", "2", "2", "--mesh_axes", "data", "rays",
             "--parallel_mode", "grid"]
# a sharded frame against the single-device frame where they are not bit
# for bit: tests/test_parallel.py's rtol / atol
MESH_FRAME_TOL = (1e-4, 1e-5)
MESH_RUNS = ("m_serial", "m_halves", "m_rays", "m_scenes", "m_grid",
             "m_part", "m_resumed", "m_eval", "m_eval1")
ALLREDUCE_REPS = 10


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nccl_collectives(mesh) -> dict:
    """On a one-rank NCCL group: every collective of
    ``parallel/collectives.py`` forward and backward, which must give its
    input back and exact gradients."""
    from ucnerf_torch.parallel import collectives as col
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(3024, 3, device=dev, generator=gen, requires_grad=True)
    g = torch.randn(3024, 3, device=dev, generator=gen)
    out = {}
    for name, fn in (("all_gather", col.all_gather),
                     ("all_reduce_sum", col.all_reduce_sum)):
        x.grad = None
        y = fn(x, mesh.group())
        y.backward(g)
        out[name] = dict(forward_exact=bool(torch.equal(y, x)),
                         grad_exact=bool(torch.equal(x.grad, g)))
    p = torch.nn.Parameter(torch.randn(1000, device=dev, generator=gen))
    p.grad = torch.randn(1000, device=dev, generator=gen)
    want = p.grad.clone()
    col.average_gradients([p], mesh.group())
    out["average_gradients"] = dict(exact=bool(torch.equal(p.grad, want)))
    t = torch.arange(17.0, device=dev)
    out["broadcast"] = dict(exact=bool(torch.equal(
        col.broadcast_(t.clone(), mesh.group()), t)))
    m = col.mean_metrics({"loss": torch.tensor(0.25, device=dev)},
                         mesh.group())
    out["mean_metrics"] = dict(exact=float(m["loss"]) == 0.25)
    out["frame_rows"] = dict(exact=bool(torch.equal(
        col.gather_rows(g, mesh.group()), g)))
    return dict(backend=mesh.backend, checks=out)


def mesh_steps(mesh, cases) -> dict:
    """For each (name, argv, steps) of ``cases``: that many multi-rank
    train steps (``make_parallel_train_step``'s loss and gradient mean)
    from the seed's weights, with the trainer's shuffle, samples and
    draws.  Before each, rank 0 computes the serial step's loss and
    gradients (``scene_loss`` of each of the step's scenes, their mean) at
    the same weights.  Per case and step: both losses, the gradients'
    worst and median rel difference, and the multi-rank step's ms (the
    serial work excluded)."""
    from ucnerf_torch.config import parse_config
    from ucnerf_torch.data import build_dataset
    from ucnerf_torch.data.device_store import (build_store, gather_batch,
                                                sample_indices)
    from ucnerf_torch.models.factory import create_models
    from ucnerf_torch.ops.rays import draw_train_randomness
    from ucnerf_torch.parallel.collectives import average_gradients
    from ucnerf_torch.parallel.sharding import (parallel_loss, scene_slot,
                                                scenes_per_step)
    from ucnerf_torch.render.serving import to_device_batch
    from ucnerf_torch.train.__main__ import step_generator
    from ucnerf_torch.train.loop import (TrainState, make_lr_schedule,
                                         make_optimizer, make_train_step,
                                         scene_loss)
    from ucnerf_torch.utils.checkpoint_io import load_params

    dev = mesh.device
    out = {}
    for name, argv, steps in cases:
        cfg = parse_config(argv)
        ds = build_dataset(cfg, "train")
        store = build_store(ds, dev)
        nerf, mvs = create_models(cfg, dev, load_params(cfg, dev))
        state = TrainState(nerf, mvs, make_optimizer(cfg, nerf, mvs))
        trained = [p for g in state.optimizer.param_groups
                   for p in g["params"]]
        n, slot = scenes_per_step(cfg, mesh), scene_slot(cfg, mesh)
        reduced = []

        def reduce(params):
            average_gradients(params, mesh.group())
            reduced[:] = [p.grad.clone() for p in params]
        step = make_train_step(cfg, make_lr_schedule(cfg, len(ds)),
                               loss_fn=parallel_loss(cfg, mesh),
                               reduce_grads=reduce)
        W, H = ds.img_wh
        kw = dict(H=H, W=W, patch_size=cfg.patch_size,
                  patch_num=cfg.patch_num, n_uniform=cfg.n_uniform_rays,
                  n_rays=cfg.n_built_rays, n_samples=cfg.N_samples)
        ds.set_epoch(0)
        order = np.random.default_rng(np.random.SeedSequence(
            [cfg.seed % 2 ** 32, 1])).permutation(len(ds))
        rows = []
        for k in range(steps):
            batches = [gather_batch(store, to_device_batch(
                sample_indices(ds, int(j)), dev))
                for j in order[k * n:(k + 1) * n]]
            draws = [draw_train_randomness(step_generator(
                cfg.seed, k, dev, None if n == 1 else s), **kw)
                for s in range(n)]
            if mesh.is_main:
                state.optimizer.zero_grad(set_to_none=True)
                losses = []
                for b, d in zip(batches, draws):
                    loss, _ = scene_loss(cfg, nerf, mvs, b, d)
                    (loss / n).backward()
                    losses.append(float(loss.detach()))
                serial = [torch.zeros_like(p) if p.grad is None
                          else p.grad.clone() for p in trained]
            sync(dev)
            t0 = time.perf_counter()
            m = step(state, batches[slot], draws[slot])
            sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            if mesh.is_main:
                rels = [float((a - b).abs().max() / max(
                    a.abs().max(), b.abs().max(), 1e-10))
                    for a, b in zip(reduced, serial)]
                rows.append(dict(loss=float(m["loss"]),
                                 serial_loss=float(np.mean(losses)),
                                 grad_worst=max(rels),
                                 grad_median=float(np.median(rels)),
                                 ms=ms))
        out[name] = rows
    return out


def allreduce_ms(mesh, numel: int) -> float:
    """ms of one all-reduce of ``numel`` float32 on the card over the
    mesh's backend, the ranks lined up by a barrier first (the step's
    gradient all-reduce also waits for the slower rank)."""
    import torch.distributed as dist
    buf = torch.ones(numel, device=mesh.device)
    dist.all_reduce(buf)
    sync(mesh.device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(ALLREDUCE_REPS):
        dist.all_reduce(buf)
    sync(mesh.device)
    return (time.perf_counter() - t0) * 1e3 / ALLREDUCE_REPS


def mesh_rank_work(mesh, plan) -> list:
    """On every rank, each (kind, argv) of ``plan`` in order: ``steps``
    (``mesh_steps`` of the cases in argv), ``allreduce`` (``allreduce_ms``
    of argv floats), or an entry point's ``main(argv)`` run on this rank
    of the mesh (``train``, ``eval`` (train recording every frame its
    validator renders), ``serve``, ``render_path``), with this rank's K1
    count set to 0 before it.  Rank 0 returns per item: the result, its
    JSON lines, every rank's K1 launches and wall s."""
    from ucnerf_torch import render_path, serve
    from ucnerf_torch.train import __main__ as train_cli

    mains = dict(train=train_cli.main, eval=train_cli.main,
                 serve=serve.main, render_path=render_path.main)
    out = []
    with recorded_eval_frames() as frames:
        for kind, argv in plan:
            out.append(rank_item(mesh, kind, argv, mains, frames))
    return out if mesh.is_main else None


def rank_item(mesh, kind, argv, mains, frames) -> dict:
    """One item of ``mesh_rank_work``'s plan on this rank."""
    from ucnerf_torch.kernels.fused_mlp import fused_nerf_mlp
    from ucnerf_torch.parallel.collectives import gather_rows
    frames.clear()
    fused_nerf_mlp.launches = 0
    buf = io.StringIO()
    sync(mesh.device)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        if kind == "steps":
            result = mesh_steps(mesh, argv)
        elif kind == "allreduce":
            result = allreduce_ms(mesh, argv)
        else:
            result = mains[kind](argv)
    sync(mesh.device)
    wall = time.perf_counter() - t0
    launches = gather_rows(torch.tensor(
        [float(fused_nerf_mlp.launches)], device=mesh.device),
        mesh.group())
    return dict(result=result, wall_s=wall,
                k1_launches=[int(v) for v in launches.tolist()],
                lines=[json.loads(ln) for ln in buf.getvalue().splitlines()
                       if ln.startswith("{")],
                frames=list(frames) if kind == "eval" else None)


@contextlib.contextmanager
def rays_rendered_in_halves():
    """In the block, the serial step's loss renders its rays in two halves
    and concatenates them, as the two ranks of ray-DP do: the same
    function, with only the order of the gradients' sums changed."""
    from ucnerf_torch.parallel.sharding import shard_rays
    from ucnerf_torch.render.renderer import make_feat_ctx, render_rays
    from ucnerf_torch.train import loop
    plain = loop.scene_loss

    def halves(cfg, nerf, mvs, batch, draws):
        imgs, mvs_out, confidence, rays = loop.scene_inputs(
            cfg, mvs, batch, draws, train=True)
        n = rays["rays_o"].shape[0]
        feat_ctx = make_feat_ctx(mvs_out, confidence, imgs[1:],
                                 batch["w2cs"][1:], batch["intrinsics"][1:])
        parts = [render_rays(nerf, shard_rays(rays, n, 2, r), feat_ctx,
                             batch["w2cs"][0], white_bkgd=cfg.white_bkgd,
                             fast=cfg.fast_featurization) for r in range(2)]
        rgb = torch.cat([p[0] for p in parts])[:n]
        depth = torch.cat([p[1] for p in parts])[:n]
        return loop.scene_loss_terms(cfg, batch, rgb, depth, rays, mvs_out)
    loop.scene_loss = halves
    try:
        yield
    finally:
        loop.scene_loss = plain


@contextlib.contextmanager
def recorded_eval_frames():
    """Every frame that the validator's eval render gives in the block, as
    numpy, in the yielded list."""
    from ucnerf_torch.train import validation
    frames = []
    make = validation.make_eval_render

    def recording(*a, **k):
        render = make(*a, **k)

        def render_view(batch):
            got = render(batch)
            frames.append([t.cpu().numpy() for t in got])
            return got
        return render_view
    validation.make_eval_render = recording
    try:
        yield frames
    finally:
        validation.make_eval_render = make


@contextlib.contextmanager
def stdout_to(path: Path):
    """Point file descriptor 1 at ``path`` for the block, so that the
    spawned ranks (which inherit it) print there."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as fh:
        os.dup2(fh.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def ckpt_params(name: str, step: int) -> dict:
    from ucnerf_torch.utils.checkpoint_io import load_params_npz
    return load_params_npz(str(OUT_DIR / name / "ckpts" / f"step_{step:08d}"
                               / "params.npz"))


def flat_arrays(tree: dict) -> list:
    return [v for k in sorted(tree) for v in (
        flat_arrays(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def params_rel(got: dict, want: dict) -> float:
    """max |got - want| over max |want|, over every tensor."""
    g, w = flat_arrays(got), flat_arrays(want)
    return float(max(np.abs(a - b).max() for a, b in zip(g, w))
                 / max(np.abs(b).max() for b in w))


def step_ms(lines) -> float:
    return float(np.median([ln["ms"] for ln in step_lines(lines)[1:]]))


def comm_ms(lines) -> dict:
    """Median per step of the collectives' ms (the gather of the per-ray
    outputs with its backward; the gradient all-reduce, which includes
    the wait for the slower rank)."""
    rows = [ln["collectives"] for ln in step_lines(lines)[1:]]
    return dict(
        gather_ms=float(np.median([r.get("gather_ms", 0.0)
                                   + r.get("gather_grad_ms", 0.0)
                                   for r in rows])),
        grad_allreduce_ms=float(np.median([r["grad_allreduce_ms"]
                                           for r in rows])),
        other_ms=float(np.median([sum(v for k, v in r.items() if k not in (
            "gather_ms", "gather_grad_ms", "grad_allreduce_ms"))
            for r in rows])))


def single_eval_frames(argv) -> tuple:
    """``--eval`` on one device: (its JSON lines, every view it renders)."""
    from ucnerf_torch.train import __main__ as train_cli
    buf = io.StringIO()
    with recorded_eval_frames() as frames, contextlib.redirect_stdout(buf):
        train_cli.main(argv)
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")], frames


def frames_agree(got, want) -> dict:
    """Bit for bit, else the largest excess over MESH_FRAME_TOL."""
    exact = all(np.array_equal(g, w) for g, w in zip(got, want))
    rtol, atol = MESH_FRAME_TOL
    excess = max(float((np.abs(g - w) - (atol + rtol * np.abs(w))).max())
                 for g, w in zip(got, want))
    return dict(bitwise=exact, within_tol=exact or excess <= 0.0,
                **frame_diff(got, want))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def group_processes(pgid: int, wait_s: float = 20.0) -> list:
    """The processes still in process group ``pgid`` after up to
    ``wait_s`` (multiprocessing's resource tracker leaves a moment after
    its parent): [(pid, command)]."""
    t0 = time.perf_counter()
    while True:
        left = []
        for d in Path("/proc").iterdir():
            if not d.name.isdigit():
                continue
            try:
                stat = (d / "stat").read_text()
                fields = stat[stat.rindex(")") + 2:].split()
                if int(fields[2]) == pgid and fields[0] != "Z":
                    left.append((int(d.name), (d / "cmdline").read_bytes()
                                 .replace(b"\0", b" ").decode()[:200]))
            except (OSError, ValueError):
                continue
        if not left or time.perf_counter() - t0 > wait_s:
            return left
        time.sleep(0.5)


def mesh_http(poses) -> dict:
    """``python -m ucnerf_torch.serve --port P --mesh_shape 2`` as its own
    process group (the entry point spawns its ranks): /health, a render of
    each pose, a malformed request (400), a render and /health again,
    then a SIGINT to the command, after which it and both ranks must be
    gone with exit code 0."""
    import signal
    import urllib.error
    import urllib.request
    port = free_port()
    log_path = OUT_DIR / "m_http_stdout.txt"
    with open(log_path, "w") as fh:
        # TF32 off in cuDNN and cuBLAS, as in this process
        proc = subprocess.Popen(
            [sys.executable, "-m", "ucnerf_torch.serve", "--port", str(port),
             "--mesh_shape", "2", *SERVE_ARGS], cwd=ROOT, stdout=fh,
            stderr=subprocess.STDOUT, start_new_session=True,
            env={**os.environ, "NVIDIA_TF32_OVERRIDE": "0"})
    url = f"http://127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        while True:
            check(proc.poll() is None, f"mesh serve exited with "
                  f"{proc.returncode}: {log_path.read_text()[-2000:]}")
            check(time.perf_counter() - t0 < MESH_TIMEOUT,
                  "mesh serve did not come up")
            try:
                with urllib.request.urlopen(url + "/health",
                                            timeout=60) as r:
                    health = [r.status, json.loads(r.read())]
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.5)
        up_s = time.perf_counter() - t0

        def post(body: bytes):
            t1 = time.perf_counter()
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        url + "/render", data=body), timeout=300) as r:
                    return r.status, r.read(), (time.perf_counter() - t1) * 1e3
            except urllib.error.HTTPError as e:
                return e.code, e.read(), (time.perf_counter() - t1) * 1e3
        frames, ms = [], []
        for c2w in poses:
            code, payload, t = post(json.dumps(
                {"c2w": np.asarray(c2w).tolist()}).encode())
            check(code == 200, f"mesh POST /render: {code}")
            with np.load(io.BytesIO(payload)) as f:
                frames.append([f[k] for k in FRAME_KEYS])
            ms.append(t)
        bad = post(b'{"c2w": [[1, 2], [3, 4]]}')[0]
        after = post(json.dumps({"c2w": np.asarray(poses[0]).tolist()})
                     .encode())[0]
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health2 = r.status
    finally:
        os.kill(proc.pid, signal.SIGINT)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            rc = proc.wait()
    left = group_processes(proc.pid)
    text = log_path.read_text()
    return dict(health=health, health_after=health2, bad_status=bad,
                after_bad_status=after, frames=frames, ms=ms, up_s=up_s,
                rc=rc, processes_left=left,
                clean_shutdown="shut down 2 ranks" in text)


def phase_mesh(dev, sv: dict, smi: str) -> dict:
    """``mesh_body``; its checkpoints and frame files are deleted after it
    whatever happens, and a failing run prints what it had measured.  Its
    line names the card and its power limit (``smi``): the times are of
    ranks that share it."""
    res = {"nvidia_smi": smi}
    try:
        mesh_body(dev, sv, res)
    except BaseException:
        log("mesh_partial", **res)
        raise
    finally:
        for name in MESH_RUNS:
            shutil.rmtree(OUT_DIR / name / "ckpts", ignore_errors=True)
        for f in ("m_frame_0.npz", "m_frame_1.npz", "m_render_path.npz"):
            (OUT_DIR / f).unlink(missing_ok=True)
    log("mesh", **res)
    return res


def mesh_body(dev, sv: dict, res: dict):
    """Multi-rank training, rendering and serving with ranks that share
    the one card (gloo), and the collectives on a one-rank NCCL group.
    Five sets of ranks: NCCL; ``python -m ucnerf_torch.train
    --mesh_shape 2`` as users run it (the ray-DP run the others are held
    to); two ranks that run in turn every step of ray-DP (plain, an odd
    ray count, --shard_mvs_views) and scene-DP against the serial step at
    the same weights (``mesh_steps``), then the entry points on the rank
    (the trainer in scene-DP, a stop and its resume, --eval, serve's batch
    mode, render_path); a 2x2 grid of four ranks (its steps, then the
    trainer); and serve's HTTP mode as its own command.  The uninterrupted
    ray-DP run is reported beside the serial run, with the serial run
    whose rays render in halves as the witness of how far a change in the
    order of the gradients' sums alone carries through Adam's steps; at
    step 1, from equal weights, both are checked.  These times are of ranks sharing one card, not
    a scaling measurement."""
    from ucnerf_torch import serve
    from ucnerf_torch.config import parse_config
    from ucnerf_torch.data import build_dataset
    from ucnerf_torch.parallel import launch
    from ucnerf_torch.train import __main__ as train_cli
    from ucnerf_torch.utils.platform import deterministic_kernels

    cfg = parse_config(MESH_ARGS)
    W, H = cfg.img_wh
    half = -(-W * H // cfg.chunk) // 2        # each rank's tiles a frame
    det = ["--deterministic"]
    stop = ["--stop_after_steps", str(MESH_STEPS)]

    def run_dir(name):
        shutil.rmtree(OUT_DIR / name, ignore_errors=True)
        return ["--basedir", str(OUT_DIR), "--expname", name]

    # 1. the collectives on a one-rank NCCL group
    nccl = launch.run_ranks("chip_smoke:nccl_collectives", (), (1,),
                            ("data",), "cuda", timeout=MESH_TIMEOUT)[0]
    res["nccl"] = nccl
    check(nccl["backend"] == "nccl" and all(
        all(v.values()) for v in nccl["checks"].values()),
        f"NCCL one-rank collectives: {nccl}")

    # 2. the serial references, in this process: 4 steps, and --eval of
    # their checkpoint view by view
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main([*MESH_ARGS, *run_dir("m_serial"), *det, *stop])
    s_lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
               if ln.startswith("{")]
    # ... and the same run with its rays rendered in halves: the order of
    # the gradients' sums alone changes, as it does on the mesh
    buf = io.StringIO()
    with rays_rendered_in_halves(), contextlib.redirect_stdout(buf):
        train_cli.main([*MESH_ARGS, *run_dir("m_halves"), *det, *stop])
    h_lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
               if ln.startswith("{")]
    ckpt = str(OUT_DIR / "m_serial" / "ckpts" / f"step_{MESH_STEPS:08d}")
    ev = [*MESH_ARGS, "--eval", "--ckpt", ckpt, "--val_panels", "none", *det]
    e1_lines, one_frames = single_eval_frames([*ev, *run_dir("m_eval1")])

    # 3. the trainer as users run it: 4 ray-DP steps on 2 ranks, spawned
    # by the entry point (its ranks print to m_rays_stdout.txt)
    out = OUT_DIR / "m_rays_stdout.txt"
    launch.last_stats.clear()
    t0 = time.perf_counter()
    with stdout_to(out):
        summary = train_cli.main([*MESH_ARGS, *run_dir("m_rays"), *det,
                                  "--mesh_shape", "2", *stop],
                                 timeout=MESH_TIMEOUT)
    r_wall = time.perf_counter() - t0
    r_stats = list(launch.last_stats)
    r_lines = [json.loads(ln) for ln in out.read_text().splitlines()
               if ln.startswith("{")]

    # 4. two ranks: every step against the serial one, then the entry
    # points on the ranks
    ds = build_dataset(cfg, "val")
    poses = [np.asarray(ds.scene[ds.metas[i][0]]["c2ws"][ds.metas[i][1]],
                        np.float32) for i in range(2)]
    reqs = OUT_DIR / "m_requests.jsonl"
    outs = [OUT_DIR / f"m_frame_{i}.npz" for i in range(2)]
    reqs.write_text("".join(json.dumps({"c2w": p.tolist(), "out": str(o)})
                            + "\n" for p, o in zip(poses, outs)))
    mesh2 = ["--mesh_shape", "2"]
    n_params = sum(a.size for a in flat_arrays(
        ckpt_params("m_serial", MESH_STEPS)))
    plan = [
        ("steps", [(name, [*MESH_ARGS, *mesh2, *flags], n)
                   for name, flags, n in MESH_CASES]),
        ("allreduce", n_params),
        ("train", [*MESH_ARGS, *run_dir("m_scenes"), *det, *mesh2,
                   "--parallel_mode", "scenes", *stop]),
        ("train", [*MESH_ARGS, *run_dir("m_part"), *det, *mesh2,
                   "--stop_after_steps", str(MESH_RESUME_STOP)]),
        ("train", [*MESH_ARGS, *run_dir("m_resumed"), *det, *mesh2, *stop,
                   "--ckpt", str(OUT_DIR / "m_part" / "ckpts"
                                 / f"step_{MESH_RESUME_STOP:08d}")]),
        ("eval", [*ev, *run_dir("m_eval"), *mesh2]),
        ("serve", ["--requests", str(reqs), *SERVE_ARGS, *mesh2]),
        ("render_path", ["--traj", "interp", "--n_frames", str(MESH_FRAMES),
                         "--out", str(OUT_DIR / "m_render_path.npz"),
                         *SERVE_ARGS, *mesh2])]
    grid_plan = [
        ("steps", [("grid", [*MESH_ARGS, *MESH_GRID], MESH_GRID_STEPS)]),
        ("train", [*MESH_ARGS, *run_dir("m_grid"), *det, *MESH_GRID,
                   "--stop_after_steps", str(MESH_GRID_STEPS)])]
    with deterministic_kernels():
        t0 = time.perf_counter()
        two = launch.run_ranks("chip_smoke:mesh_rank_work", (plan,), (2,),
                               ("data",), "cuda", timeout=MESH_TIMEOUT)[0]
        two_wall = time.perf_counter() - t0
        two_stats = list(launch.last_stats)
        t0 = time.perf_counter()
        four = launch.run_ranks("chip_smoke:mesh_rank_work", (grid_plan,),
                                (2, 2), ("data", "rays"), "cuda",
                                timeout=MESH_TIMEOUT)[0]
        four_wall = time.perf_counter() - t0
        four_stats = list(launch.last_stats)
        renderer, _ = serve.build_renderer(parse_config(SERVE_ARGS))
        single = [renderer.render_np(p) for p in poses]
        del renderer
    steps_two, gloo_ms, scenes, part, resumed, evm, served, rp = two
    steps_four, grid = four
    res["ranks"] = dict(
        rays_cli_wall_s=r_wall, two_rank_wall_s=two_wall,
        grid_wall_s=four_wall,
        peak_mem_gib=dict(rays_cli=[s["peak_mem_bytes"] / 2 ** 30
                                    for s in r_stats],
                          two_rank=[s["peak_mem_bytes"] / 2 ** 30
                                    for s in two_stats],
                          grid=[s["peak_mem_bytes"] / 2 ** 30
                                for s in four_stats]))

    # every mode's steps against the serial step at the same weights
    per_step = {}
    for name, rows in {**steps_two["result"], **steps_four["result"]}.items():
        rtol = (MESH_RAY_LOSS_RTOL if name in ("rays", "rays_odd")
                else MESH_SCENE_LOSS_RTOL)
        rel = [abs(r["loss"] - r["serial_loss"]) / abs(r["serial_loss"])
               for r in rows]
        per_step[name] = dict(
            loss=[r["loss"] for r in rows],
            serial_loss=[r["serial_loss"] for r in rows], loss_rel=rel,
            grad_worst=[r["grad_worst"] for r in rows],
            grad_median=[r["grad_median"] for r in rows],
            ms_per_step=float(np.median([r["ms"] for r in rows[1:]])),
            loss_rtol=rtol)
    res["per_step"] = per_step
    for name, p in per_step.items():
        check(max(p["loss_rel"]) <= p["loss_rtol"]
              and max(p["grad_worst"]) <= MESH_GRAD_RTOL,
              f"{name} steps vs serial: {p}")

    # the trainer's runs of each mode: their steps are the checked ones
    runs = {}
    for name, lines, ref, extra in (
            ("m_rays", r_lines, "rays", dict(wall_s=r_wall)),
            ("m_scenes", scenes["lines"], "scenes",
             dict(wall_s=scenes["wall_s"])),
            ("m_grid", grid["lines"], "grid", dict(wall_s=grid["wall_s"]))):
        got = [ln["loss"] for ln in step_lines(lines)]
        summ = lines[-1]
        runs[name] = dict(loss=got, equals_checked_steps=(
            got == per_step[ref]["loss"]), ms_per_step=step_ms(lines),
            collectives=comm_ms(lines), world_size=summ["world_size"],
            backend=summ["backend"], **extra)
    # the uninterrupted runs drift apart through Adam's updates: the mesh's
    # and the serial run with its rays in halves, each against the serial
    serial_loss = [ln["loss"] for ln in step_lines(s_lines)]
    drift = {}
    for name, got in (("m_rays", runs["m_rays"]["loss"]), (
            "m_halves", [ln["loss"] for ln in step_lines(h_lines)])):
        drift[name] = dict(
            loss=got, loss_rel=[abs(g - w) / abs(w)
                                for g, w in zip(got, serial_loss)],
            params_rel=params_rel(ckpt_params(name, MESH_STEPS),
                                  ckpt_params("m_serial", MESH_STEPS)))
    runs["m_rays"]["uninterrupted_vs_serial"] = dict(
        serial_loss=serial_loss, serial_ms_per_step=step_ms(s_lines),
        **drift)
    # the first step starts from the same weights: the same loss
    check(all(len(d["loss_rel"]) == MESH_STEPS
              and d["loss_rel"][0] <= MESH_RAY_LOSS_RTOL
              for d in drift.values()),
          f"uninterrupted runs vs serial at step 1: {drift}")
    runs["gloo_allreduce_ms"] = dict(floats=n_params, ms=gloo_ms["result"])
    res["train"] = runs
    for name, ref in (("m_rays", "rays"), ("m_scenes", "scenes"),
                      ("m_grid", "grid")):
        got, want = runs[name]["loss"], per_step[ref]["loss"]
        check(len(got) == len(want) and all(
            abs(g - c) <= MESH_RAY_LOSS_RTOL * abs(c)
            for g, c in zip(got, want))
            and runs[name]["world_size"] == (4 if ref == "grid" else 2),
            f"{name}: the trainer's steps are not the checked ones: "
            f"{runs[name]}")
    check(summary["world_size"] == 2 and summary["backend"] == "gloo",
          f"m_rays summary: {summary}")

    # 5. the ray-DP resume against the uninterrupted run
    keys = ("loss", "img_mse", "nerf_depth", "mvs", "smooth", "scaleinv",
            "psnr", "lr")
    rs, us = step_lines(resumed["lines"]), step_lines(r_lines)[
        MESH_RESUME_STOP:]
    res["resume"] = dict(
        steps=[ln["step"] for ln in rs],
        terms_bitwise=all(r[k] == u[k] for r, u in zip(rs, us)
                          for k in keys),
        params_bitwise=params_rel(ckpt_params("m_resumed", MESH_STEPS),
                                  ckpt_params("m_rays", MESH_STEPS)) == 0.0)
    check(part["lines"][-1]["stopped"] and len(rs) == len(us)
          == MESH_STEPS - MESH_RESUME_STOP and res["resume"]["terms_bitwise"]
          and res["resume"]["params_bitwise"],
          f"mesh resume vs uninterrupted: {res['resume']}")

    # 6. --eval on 2 ranks against one device, view by view
    views = [frames_agree(g, w) for g, w in zip(evm["frames"], one_frames)]
    [v1] = [ln for ln in e1_lines if "val_step" in ln]
    [v2] = [ln for ln in evm["lines"] if "val_step" in ln]
    n_val = len(one_frames)
    res["eval"] = dict(
        views=n_val, per_view=views, bitwise=all(v["bitwise"] for v in views),
        ms_per_view=v2["ms_per_view"], single_ms_per_view=v1["ms_per_view"],
        k1_launches_per_rank=evm["k1_launches"])
    check(len(evm["frames"]) == n_val and all(v["within_tol"] for v in views)
          and evm["k1_launches"] == [n_val * half] * 2,
          f"sharded --eval vs one device: {res['eval']}")

    # 7. serve's batch mode and render_path on 2 ranks; HTTP
    batch = []
    for o in outs:
        with np.load(o) as f:
            batch.append([f[k] for k in FRAME_KEYS])
    vs_phase = []
    for i, b in enumerate(batch):       # phase serving's default kernels
        with np.load(OUT_DIR / f"frame_{i:03d}.npz") as f:
            vs_phase.append(frame_diff(b, [f[k] for k in FRAME_KEYS]))
    [summ] = [ln for ln in served["lines"] if "frames" in ln]
    per_frame = [frames_agree(b, s) for b, s in zip(batch, single)]
    http = mesh_http(poses)
    http_vs = [frame_diff(h, b) for h, b in zip(http.pop("frames"), batch)]
    with np.load(OUT_DIR / "m_render_path.npz") as f:
        rp_ok = (f["rgb"].shape == (MESH_FRAMES, H, W, 3)
                 and np.isfinite(f["rgb"]).all()
                 and np.isfinite(f["depth"]).all())
    res["serve"] = dict(
        frames=served["result"], per_frame=per_frame,
        ms_per_frame=summ["ms_per_frame"],
        single_ms_per_frame=sv["serve_ms_per_frame"],
        vs_phase_serving=vs_phase, k1_launches_per_rank=served["k1_launches"],
        http=dict(http, vs_batch=http_vs),
        render_path=dict(frames=rp["result"]["frames"], ok=bool(rp_ok),
                         steady_ms_per_frame=rp["result"][
                             "steady_ms_per_frame"],
                         k1_launches_per_rank=rp["k1_launches"]))
    res["k1_launches"] = sum(evm["k1_launches"] + served["k1_launches"]
                             + rp["k1_launches"])
    res["note"] = ("ranks share one card: times are not a scaling "
                   "measurement")
    check(served["result"] == 2 and all(v["within_tol"] for v in per_frame)
          and served["k1_launches"] == [3 * half] * 2,   # + warm-up frame
          f"mesh serve batch: {res['serve']}")
    check(http["health"][0] == 200 and http["health"][1]["world_size"] == 2
          and http["health_after"] == 200 and http["bad_status"] == 400
          and http["after_bad_status"] == 200 and http["rc"] == 0
          and http["clean_shutdown"] and not http["processes_left"]
          and all(d[k] <= HTTP_TOL for d in http_vs for k in (
              "rgb_mean_abs", "depth_mean_abs", "confidence_mean_abs")),
          f"mesh HTTP: {res['serve']['http']}")
    check(rp_ok and rp["result"]["frames"] == MESH_FRAMES
          and rp["k1_launches"] == [MESH_FRAMES * half] * 2,
          f"mesh render_path: {res['serve']['render_path']}")


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
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out
    smi = phase_device()
    dev = torch.device("cuda", 0)
    cfg = parse_config(SERVE_ARGS)
    timed("build", phase_build)
    k1 = timed("k1", phase_k1, cfg, dev)
    sv = timed("serving", phase_serving, cfg, dev)
    hp = timed("http", phase_http, cfg, dev)
    rp = timed("render_path", phase_render_path, cfg)
    tr = timed("train", phase_train, dev)
    op = timed("options", phase_options, dev, tr, sv)
    try:
        sd = timed("scared", phase_scared, dev, tr)
        pp = timed("preprocess", phase_preprocess, dev, sd)
    finally:     # the scan, the weights and the checkpoints are large
        shutil.rmtree(SCAN_DIR, ignore_errors=True)
        shutil.rmtree(PRE_DIR, ignore_errors=True)
        for name in ("s_train", "s_eval", "p_eval"):
            shutil.rmtree(OUT_DIR / name / "ckpts", ignore_errors=True)
    mh = timed("mesh", phase_mesh, dev, sv, smi)
    record = {"k1": k1, "serving": sv, "http": hp, "render_path": rp,
              "train": tr, "options": op, "scared": sd, "preprocess": pp,
              "mesh": mh, "nvidia_smi": smi,
              "seconds": time.perf_counter() - t_start,
              "phase_seconds": seconds}
    (OUT_DIR / "result.json").write_text(json.dumps(record, indent=1))
    log("seconds", total=record["seconds"], **seconds)
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_nerf_mlp", "route": "cuda",
        "source": "ucnerf_torch/csrc/fused_mlp.cu",
        "replaces": "ucnerf_tpu/pallas/mlp_kernel.py:115",
        "launches": (sv["launches"] + hp["launches"] + rp["launches"]
                     + tr["k1_launches"] + op["k1_launches"]
                     + sd["k1_launches"] + pp["k1_launches"]
                     + mh["k1_launches"]),
        "max_abs_err": k1["serving"]["bf16_vs_plain_bf16_max_abs_err"],
        "ms": k1["bf16_ms"], "plain_ms": k1["plain_bf16_ms"],
        "bound_ms": k1["bound_bf16_ms"], "bound_by": k1["bound_by_bf16"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
