"""K1's float32 kernel against three rewrites of its own source, on a CUDA
card at phase ``k1``'s serving tile (1024 rays x 90 samples, V=7), to
show what each choice of its 3xTF32 design buys.

    python3 scripts/k1_f32_variants.py

Rows, each a copy of ``ucnerf_torch/csrc/fused_mlp.cu`` with one change,
built with the package's nvcc flags into ``ucnerf_torch/_build/variants/``:
``kernel`` (the source as it is), ``cvt_rna`` (the activations' tf32
rounding by ``cvt.rna.tf32.f32`` instead of bit arithmetic),
``direct_acc`` (the three products of each k-tile added into the layer's
accumulator itself, not into a fresh one), ``one_pass`` (big x big alone:
plain TF32).  For each: ptxas' registers and spills, the SASS instruction
mix (``cuobjdump``), max abs error against the plain f32 MLP (TF32 off)
at the serving tile and a ragged one, and ms per launch (CUDA events, the
mean of 30 after 3 warm-ups; the rows timed in turns, three times).
Prints the card's name and power limit and one JSON line (also written to
``chiprun_out/k1_f32_variants.json``).  Needs one card; it is not part of
``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KERNEL_SPLIT = """__device__ __forceinline__ uint32_t tf32_big(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}"""
PARTIAL = """  float d[4];
  mma_tf32_zero(d, as, bb0, bb1);
  mma_tf32(d, ab, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ab, bb0, bb1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];"""
# row -> (text of the kernel's source, its replacement)
VARIANTS = {
    "kernel": None,
    "cvt_rna": (KERNEL_SPLIT, """\
__device__ __forceinline__ uint32_t tf32_big(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r;
}"""),
    "direct_acc": (PARTIAL, """  mma_tf32(acc, as, bb0, bb1);
  mma_tf32(acc, ab, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(acc, ab, bb0, bb1);"""),
    "one_pass": (PARTIAL, """  float d[4];
  mma_tf32_zero(d, ab, bb0, bb1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];"""),
}


def sass_mix(so: Path, nvcc: str) -> dict:
    """Static SASS opcodes of the f32 kernel, most frequent first."""
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(so)], capture_output=True, text=True,
                          check=True).stdout
    body = sass[sass.find("fused_mlp_f32_kernel"):]
    end = body.find("Function :", 10)
    hist = {}
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)", body[:end] if end > 0
                         else body):
        hist[m.group(1)] = hist.get(m.group(1), 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: -kv[1])[:12])


def build_variant(name: str, edit) -> dict:
    import chip_smoke
    from ucnerf_torch.kernels import build
    src = (build.CSRC / "fused_mlp.cu").read_text()
    if edit is not None:
        old, new = edit
        if src.count(old) != 1:
            raise SystemExit(f"k1_f32_variants: {name}: the kernel's source "
                             f"no longer holds the text this row replaces")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    nvcc = build.find_nvcc()
    so = out / f"lib_{name}.so"
    proc = subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(so),
                           str(out / f"{name}.cu")], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"k1_f32_variants: {name} failed to build:\n"
                         f"{proc.stderr[-3000:]}")
    return dict(so=so, ptxas=chip_smoke.ptxas_by_kernel(proc.stderr)
                .get("fused_mlp_f32_kernel"), sass=sass_mix(so, nvcc))


def main():
    import chip_smoke as c
    smi = c.phase_device()
    import torch
    from ucnerf_torch.config import parse_config
    from ucnerf_torch.kernels import fused_mlp as fm
    from ucnerf_torch.models.factory import create_models, init_params

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS,
                                            VARIANTS.values())))
    libs = {}
    for name, b in built.items():
        fn = ctypes.CDLL(str(b["so"])).ucnerf_fused_mlp_forward
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
    dev = torch.device("cuda", 0)
    cfg = parse_config(c.SERVE_ARGS)
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    nerf = create_models(cfg.replace(nerf_dtype="float32"), dev, params)[0]
    fused = fm.FusedNeRFMLP(nerf)
    S = cfg.N_samples
    x = c.mlp_inputs(cfg.chunk, S, cfg.feat_dim, 1, dev)
    xr = c.mlp_inputs(37, S, cfg.feat_dim, 1, dev)
    rows = {n: dict(ptxas=b["ptxas"], sass=b["sass"], ms=[])
            for n, b in built.items()}
    kernel_lib = fm._kernel_lib
    try:
        with torch.no_grad():
            truth, truth_r = nerf(*x), nerf(*xr)
            for n, fn in libs.items():
                fm._kernel_lib = lambda fn=fn: fn
                rows[n]["max_abs_err"] = (fused(*x) - truth).abs().max().item()
                rows[n]["ragged_max_abs_err"] = (
                    fused(*xr) - truth_r).abs().max().item()
            order = list(libs)
            for n in order + order[::-1] + order:
                fm._kernel_lib = lambda fn=libs[n]: fn
                rows[n]["ms"].append(c.time_ms(lambda: fused(*x), iters=30))
    finally:
        fm._kernel_lib = kernel_lib
    res = dict(points=cfg.chunk * S, nvidia_smi=smi, rows=rows)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k1_f32_variants.json").write_text(
        json.dumps(res, indent=1))
    print(smi)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
