"""Build the port's native sources into shared libraries at first use.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a``; each
``csrc/*.cpp`` file (host code, such as the JPEG decoder) with ``$CXX`` or
``g++``.  The library goes to ``ucnerf_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags so an edited
source rebuilds, and loads with ``ctypes``.  A build writes a temporary
name and renames it, so processes that build at once do not collide.  The
libraries export plain C functions (the CUDA ones take device pointers and
a stream).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared"]


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels build on a machine with the CUDA toolkit")
    return nvcc


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on the PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx or shutil.which(cxx) is None:
        raise RuntimeError(
            "no C++ compiler found (set CXX or install g++); the port's "
            "host code (csrc/*.cpp, e.g. the JPEG decoder) builds at first "
            "use and has no fallback")
    return cxx


def _source(name: str) -> Path:
    for ext in (".cu", ".cpp"):
        if (CSRC / f"{name}{ext}").exists():
            return CSRC / f"{name}{ext}"
    raise FileNotFoundError(f"no source csrc/{name}.cu or .cpp")


def library_path(name: str) -> Path:
    src = _source(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (the host
    compiler) unless its library exists.  Returns {'path', 'seconds',
    'ptxas'} (ptxas: the compiler's register / shared memory report, empty
    when nothing was built or the source is host code)."""
    out = library_path(name)
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "ptxas": ""}
    src = _source(name)
    cmd = ([find_nvcc(), *NVCC_FLAGS] if src.suffix == ".cu"
           else [find_cxx(), *CXX_FLAGS])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed for {src.name}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "ptxas": proc.stderr if src.suffix == ".cu" else ""}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built if
    needed."""
    return ctypes.CDLL(build(name)["path"])
