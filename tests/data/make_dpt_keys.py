"""Record the state-dict layout of transformers' hybrid DPT models
(``dpt_hybrid_state_dicts.json``): for ``DPTForDepthEstimation`` and
``DPTForSemanticSegmentation`` (150 ADE20K labels), in the hybrid MiDaS
configuration of ``tests/test_dpt.py``, the number of entries, of
parameters, and the SHA-256 of the listing "name (shape) dtype" one entry
per line in state-dict order.  The models are built on the meta device, so
no weights are drawn or fetched.

    python tests/data/make_dpt_keys.py

``tests/test_torch_dpt.py`` holds ``ucnerf_torch.models.dpt``'s seeded
state dicts to the record, so the port's weights carry the published names,
shapes and dtypes without importing transformers in the tests.
"""

import hashlib
import json
import os
from pathlib import Path

os.environ.setdefault("USE_TF", "0")

import torch
from transformers import (DPTConfig, DPTForDepthEstimation,
                          DPTForSemanticSegmentation)

HERE = Path(__file__).resolve().parent
HYBRID = dict(is_hybrid=True, neck_hidden_sizes=[256, 512, 768, 768],
              reassemble_factors=[1, 1, 1, 0.5],
              backbone_out_indices=[2, 5, 8, 11], readout_type="project",
              backbone_featmap_shape=[1, 1024, 24, 24])


def listing(entries) -> str:
    """One line per (name, shape, dtype name), e.g.
    ``head.head.4.bias (1,) float32``."""
    return "".join(f"{k} {tuple(shape)} {dtype}\n"
                   for k, shape, dtype in entries)


def record(entries) -> dict:
    text = listing(entries)
    n = 0
    for _, shape, _ in entries:
        size = 1
        for d in shape:
            size *= d
        n += size
    return {"entries": len(entries), "parameters": n,
            "sha256": hashlib.sha256(text.encode()).hexdigest()}


def main():
    with torch.device("meta"):
        models = {"depth": DPTForDepthEstimation(DPTConfig(**HYBRID)),
                  "seg": DPTForSemanticSegmentation(DPTConfig(
                      **HYBRID, use_batch_norm_in_fusion_residual=True,
                      num_labels=150))}
    out = {task: record([(k, tuple(v.shape), str(v.dtype).replace(
                              "torch.", ""))
                         for k, v in m.state_dict().items()])
           for task, m in models.items()}
    (HERE / "dpt_hybrid_state_dicts.json").write_text(
        json.dumps(out, indent=1) + "\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
