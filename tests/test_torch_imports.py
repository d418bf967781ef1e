"""ucnerf_torch and chip_smoke.py import nothing of JAX, of the JAX package,
or of the image libraries the card's machine lacks."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ucnerf_tpu", "cv2", "PIL",
             "imageio"}
FILES = sorted((ROOT / "ucnerf_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serve_imports_with_jax_blocked():
    """The entry points ``ucnerf_torch.serve`` and ``ucnerf_torch.train``,
    and the modules the trainer loads (validation, metrics, LPIPS,
    checkpoints, the device store, writer, prefetcher, profiling), import
    when importing jax fails."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'ucnerf_tpu', 'cv2', 'PIL',"
            " 'imageio'):\n"
            "    sys.modules[m] = None\n"
            "import ucnerf_torch.serve, ucnerf_torch.kernels.fused_mlp\n"
            "import ucnerf_torch.train.__main__\n"
            "import ucnerf_torch.train.validation, ucnerf_torch.eval\n"
            "import ucnerf_torch.eval.lpips, ucnerf_torch.eval.metrics\n"
            "import ucnerf_torch.utils.checkpoint_io\n"
            "import ucnerf_torch.data.device_store\n"
            "import ucnerf_torch.utils.writer, ucnerf_torch.utils.prefetch\n"
            "import ucnerf_torch.utils.profiling\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
