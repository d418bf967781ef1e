"""ucnerf_torch, chip_smoke.py and chip_quality.py import nothing of JAX,
of the JAX package, of the image libraries the card's machine lacks, or
of transformers."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ucnerf_tpu", "cv2", "PIL",
             "imageio", "matplotlib", "transformers"}
FILES = sorted((ROOT / "ucnerf_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_quality.py"]


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
    """The entry points ``ucnerf_torch.serve``, ``ucnerf_torch.train`` and
    ``ucnerf_torch.render_path``, and the modules they load (validation,
    metrics, LPIPS, checkpoints, the device store, writer, prefetcher,
    profiling, PNG, panels, trajectories, the SCARED / Hamlyn / finetune
    datasets, COLMAP I/O, poses, the JPEG decoder's and the native COLMAP
    loader's bindings and the resize twins), and ``ucnerf_torch.preprocess`` and
    ``ucnerf_torch.convert_weights`` with theirs (DPT, COLMAP's wrapper and
    dense I/O), the ops tail (geometry, the grid samplers) and the
    multi-rank modules (``ucnerf_torch.parallel.*``), import when
    importing jax, the image libraries and transformers fails."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'ucnerf_tpu', 'cv2', 'PIL',"
            " 'imageio', 'matplotlib', 'transformers'):\n"
            "    sys.modules[m] = None\n"
            "import ucnerf_torch.serve, ucnerf_torch.kernels.fused_mlp\n"
            "import ucnerf_torch.train.__main__\n"
            "import ucnerf_torch.train.validation, ucnerf_torch.eval\n"
            "import ucnerf_torch.eval.lpips, ucnerf_torch.eval.metrics\n"
            "import ucnerf_torch.utils.checkpoint_io\n"
            "import ucnerf_torch.data.device_store\n"
            "import ucnerf_torch.utils.writer, ucnerf_torch.utils.prefetch\n"
            "import ucnerf_torch.utils.profiling\n"
            "import ucnerf_torch.render_path, ucnerf_torch.utils.png\n"
            "import ucnerf_torch.utils.viz, ucnerf_torch.utils.pose_traj\n"
            "import ucnerf_torch.data.scared, ucnerf_torch.data.finetune\n"
            "import ucnerf_torch.data.colmap, ucnerf_torch.data.llff\n"
            "import ucnerf_torch.data.image_io, ucnerf_torch.data.resize\n"
            "import ucnerf_torch.utils.jpeg, ucnerf_torch.kernels.build\n"
            "import ucnerf_torch.data.native\n"
            "import ucnerf_torch.preprocess, ucnerf_torch.convert_weights\n"
            "import ucnerf_torch.models.dpt, ucnerf_torch.data.colmap_dense\n"
            "import ucnerf_torch.data.colmap_wrapper\n"
            "import ucnerf_torch.ops.geometry, ucnerf_torch.ops.grid_sample\n"
            "import ucnerf_torch.parallel.mesh, ucnerf_torch.parallel.launch\n"
            "import ucnerf_torch.parallel.collectives\n"
            "import ucnerf_torch.parallel.mvs_views\n"
            "import ucnerf_torch.parallel.sharding\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
