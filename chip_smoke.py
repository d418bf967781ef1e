"""Smoke test of ucnerf_torch on one CUDA card: builds the port's kernels,
holds each against its plain PyTorch version, serves novel views at the
SCARED operating point through ``python -m ucnerf_torch.serve``'s entry
point, and trains at the SCARED train point through ``python -m
ucnerf_torch.train``'s: a run stopped at a checkpoint, its resume against
an uninterrupted run, ``--eval`` of the checkpoint over the whole val
split, and the device scene store against host loading.

    python3 chip_smoke.py

Phases (one line each): device, build, K1 vs plain, serving, resume,
store_vs_host, train.  Any failed check raises, so the script exits
non-zero and prints no result.  Before the last line it prints the card's
``nvidia-smi`` name and power limit and one JSON line with every kernel of
the serving and train paths; the last line is ``{"ok": true, "device":
{...}}``.  Frames, the trainer runs' stdout and directories (metrics,
test results; their checkpoints are deleted once checked), profiles and a
JSON record go to ``chiprun_out/chip_smoke/`` beside this file.
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
# the train point of bench.py: 2000 rays (50 patches of 6x6 + 200 uniform)
# + 1024 sparse-depth rays, 90 samples per ray, cascade depths 48/32/8
TRAIN_ARGS = [*SERVE_ARGS, "--batch_size", "2000", "--patch_size", "6",
              "--patch_num", "50", "--n_depth_rays", "1024", "--N_samples",
              "90", "--num_epochs", "30", "--chunk", "1024"]
TRAIN_STEPS = 12           # the run that stops at a checkpoint
RESUME_STEPS = 16          # its resume, and the uninterrupted run
OVERFIT_STEPS = 30
DET_STEPS = 8              # the overfit step again on deterministic kernels
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
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
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
    from ucnerf_torch.kernels import build
    t0 = time.perf_counter()
    res = build.build("fused_mlp")
    log("build", kernel="fused_mlp", seconds=time.perf_counter() - t0,
        nvcc_seconds=res["seconds"], ptxas=ptxas_by_kernel(res["ptxas"]))


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


def kernel_vs_plain_frame(cfg, params, batch, img_hw, dev) -> dict:
    """One frame rendered with K1 and with the plain MLP (at
    ``cfg.nerf_dtype``) from ONE cascade output, so the diff is the MLP's
    alone (the cascade's cuDNN convolutions need not be bit-reproducible).
    The caller resets K1's launch count after."""
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
                    got["plain"][1]).clip(1e-6)).mean()))


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
                                       dev)
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


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels for the block (sort-based scatter-adds,
    deterministic cuDNN algorithms; cuBLAS needs CUBLAS_WORKSPACE_CONFIG,
    which ``main`` sets).  With the card's default kernels two identical
    runs differ after one step: the atomic scatter-adds of the backward
    change round-off, and Adam's first updates, about lr * sign(gradient),
    turn that into differences of a whole learning rate."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def run_trainer(name: str, *argv) -> tuple:
    """One ``ucnerf_torch.train`` run on the bench scene under
    OUT_DIR/``name``: (summary, JSON lines, wall seconds); its output is
    kept in OUT_DIR/``name``_stdout.txt."""
    from ucnerf_torch.train import __main__ as train_cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with bench_scene(), contextlib.redirect_stdout(buf):
        summary = train_cli.main([*TRAIN_ARGS, "--basedir", str(OUT_DIR),
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
    whole val split on K1, then K1 vs the plain MLP on its first view; (d)
    one sample store-fed against host-fed.  (a), (b) and (d) run on
    deterministic kernels, so that their comparisons see the code and not
    the card's atomics.  Then an overfit of one sample through
    make_train_step (default kernels), its last step profiled, and one
    small-shape step on the card vs the CPU."""
    from ucnerf_torch.config import parse_config
    from ucnerf_torch.data import build_dataset
    from ucnerf_torch.kernels.fused_mlp import fused_nerf_mlp
    from ucnerf_torch.models.factory import create_models, init_params
    from ucnerf_torch.ops.rays import draw_train_randomness
    from ucnerf_torch.render.serving import to_device_batch
    from ucnerf_torch.train.loop import (TrainState, make_lr_schedule,
                                         make_optimizer, make_train_step)
    from ucnerf_torch.utils import checkpoint_io

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
    with deterministic():
        summary, lines, wall = run_trainer("a_train", "--stop_after_steps",
                                           str(TRAIN_STEPS))
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
    with deterministic():
        _, r_lines, _ = run_trainer("b_resumed", "--ckpt", str(ckpt),
                                    "--stop_after_steps", str(RESUME_STEPS))
        _, u_lines, _ = run_trainer("b_whole", "--config", str(host_cfg),
                                    "--stop_after_steps", str(RESUME_STEPS))
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
    check(resume["resumed_steps"] == list(range(TRAIN_STEPS + 1,
                                                RESUME_STEPS + 1))
          and resume["resumed_lr"] == resume["whole_lr"]
          and len(loss_rel) == RESUME_STEPS - TRAIN_STEPS
          and max(loss_rel) <= 1e-3,
          f"resume vs uninterrupted: {resume}")
    check(fused_nerf_mlp.launches == 0,
          f"stopped runs launched K1 {fused_nerf_mlp.launches} times")

    # (c) --eval of the checkpoint over the whole val split on K1
    with bench_scene():
        val_ds = build_dataset(cfg, "val")
    ev_summary, ev_lines, ev_wall = run_trainer("c_eval", "--eval", "--ckpt",
                                                str(ckpt))
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

    # K1 vs the plain bf16 MLP on the checkpoint's first val view
    trained = checkpoint_io.checkpoint_params(str(ckpt))
    diff = kernel_vs_plain_frame(cfg, trained,
                                 to_device_batch(val_ds[0], dev), (H, W),
                                 dev)
    fused_nerf_mlp.launches = launches   # comparison launches do not count
    check(diff["rgb_mean_abs"] <= 5e-3 and diff["depth_mean_rel"] <= 5e-3,
          f"bf16 kernel validation frame vs plain frame: {diff}")

    # (d) one sample store-fed against host-fed
    with deterministic():
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
    with deterministic():
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
               k1_launches_expected=len(val_ds) * n_tiles,
               kernel_vs_plain_val_frame=diff, store_vs_host=svh,
               overfit_losses=losses, overfit_drop=1.0 - last / first,
               step_profile=profile,
               device_idle_share=profile["device_idle_share"],
               card_vs_cpu=cc)
    log("train", **res)
    return res


def main():
    sys.path.insert(0, str(ROOT))
    try:
        from ucnerf_torch.config import parse_config
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the ucnerf_torch package is missing "
                         f"beside this script ({e})")
    # cuBLAS is deterministic only with a fixed workspace; set before the
    # first cuBLAS call (phase train's ``deterministic`` blocks need it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = phase_device()
    dev = torch.device("cuda", 0)
    cfg = parse_config(SERVE_ARGS)
    phase_build()
    k1 = phase_k1(cfg, dev)
    sv = phase_serving(cfg, dev)
    tr = phase_train(dev)
    record = {"k1": k1, "serving": sv, "train": tr, "nvidia_smi": smi}
    (OUT_DIR / "result.json").write_text(json.dumps(record, indent=1))
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_nerf_mlp", "route": "cuda",
        "source": "ucnerf_torch/csrc/fused_mlp.cu",
        "replaces": "ucnerf_tpu/pallas/mlp_kernel.py:115",
        "launches": sv["launches"] + tr["k1_launches"],
        "max_abs_err": k1["serving"]["bf16_vs_plain_bf16_max_abs_err"],
        "ms": k1["bf16_ms"], "plain_ms": k1["plain_bf16_ms"],
        "bound_ms": k1["bound_bf16_ms"], "bound_by": k1["bound_by_bf16"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
