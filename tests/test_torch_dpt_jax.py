"""The port's DPT-Hybrid (``ucnerf_torch.models.dpt``) against the JAX
package's at full width, with seeded weights under transformers' names
(no published weights are in the repository): on a 64x64 image (the /16
map is 4x4, so the position embeddings resize from 24x24) the trunk, the
depth output and the segmentation logits in f32, and the bf16 trunk
against JAX's bf16 trunk.  Three tests, so that pytest-xdist's ``--dist
loadfile`` queues this file after the suite's long JAX files.

Tolerances (f32 on one CPU thread; measured beside each): the trunk and
the logits rel-to-max 1e-4; the depth output, ReLU'd and up to ~80 here,
max abs 2e-3 (2.5e-5 of its max); the bf16 trunk rel-to-max 6e-2 against
JAX's bf16 trunk, the bound ``tests/test_dpt.py`` puts on JAX's bf16 trunk
against its f32 one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.models import dpt as J

from ucnerf_torch.models import dpt as T

from test_torch_dpt import IMG, JIT_QUICK, _nchw, _rel_to_max

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    """Seeded depth and segmentation weights (one trunk) in the JAX
    layouts, as ``convert_dpt_torch_state_dict`` of either package gives
    them."""
    depth = T.seeded_dpt_state_dict(0)
    seg = T.seeded_dpt_state_dict(0, "seg", shared=depth)
    return {"depth": T.convert_dpt_torch_state_dict(depth),
            "seg": T.convert_dpt_torch_state_dict(seg)}


def _jax_trunk_and_head(p, head, monkeypatch):
    """JAX's ``_dpt_trunk`` of IMG, then ``head`` (``dpt_forward`` or
    ``dpt_seg_forward`` of the JAX package) on that trunk: the head runs
    with ``_dpt_trunk`` answering the map already computed, so the trunk
    compiles once."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    trunk = jax.jit(J._dpt_trunk, compiler_options=JIT_QUICK)(
        jp, jnp.asarray(IMG))
    with monkeypatch.context() as m:
        m.setattr(J, "_dpt_trunk", lambda p, img: trunk)
        out = jax.jit(lambda p, img: head(p, img),
                      compiler_options=JIT_QUICK)(jp, jnp.asarray(IMG))
    return np.asarray(trunk), np.asarray(out)


def test_dpt_matches_jax(weights, monkeypatch):
    j_trunk, j_depth = _jax_trunk_and_head(weights["depth"], J.dpt_forward,
                                           monkeypatch)
    p = T.to_torch_params(weights["depth"])
    with torch.no_grad():
        fused = T._dpt_trunk(p, _nchw(IMG))
        depth = T._depth_head(p, fused)
    trunk = fused[0].permute(1, 2, 0).numpy()
    assert trunk.shape == (32, 32, T.FUSION)
    assert depth.shape == (1, 64, 64) and depth.dtype == torch.float32
    rel = _rel_to_max(trunk, j_trunk)
    assert rel < 1e-4, rel                                 # measured 1.4e-6
    err = np.abs(depth[0].numpy() - j_depth).max()
    assert err < 2e-3, err                                 # measured 1.4e-4


def test_dpt_seg_matches_jax(weights, monkeypatch):
    j_trunk, want = _jax_trunk_and_head(weights["seg"], J.dpt_seg_forward,
                                        monkeypatch)
    p = T.to_torch_params(weights["seg"])
    with torch.no_grad():
        trunk = T._dpt_trunk(p, _nchw(IMG))
        got = T.dpt_seg_forward(p, _nchw(IMG))[0].permute(1, 2, 0).numpy()
    rel = _rel_to_max(trunk[0].permute(1, 2, 0).numpy(), j_trunk)
    assert rel < 1e-4, rel
    assert got.shape == want.shape == (64, 64, T.ADE20K_LABELS)
    rel = _rel_to_max(got, want)
    assert rel < 1e-4, rel                                 # measured 1.7e-6


def test_dpt_bf16_trunk_matches_jax_bf16(weights):
    """``dtype="bfloat16"``: every float parameter in bf16, norm scales and
    BN running statistics too; the trunk against JAX's bf16 trunk; the
    outputs stay f32."""
    jp = {k: jnp.asarray(v.astype(jnp.bfloat16))
          for k, v in weights["depth"].items()}
    want = np.asarray(jax.jit(J._dpt_trunk, compiler_options=JIT_QUICK)(
        jp, jnp.asarray(IMG, jnp.bfloat16)).astype(jnp.float32))
    p = T.to_torch_params(weights["depth"], "bfloat16")
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    bn = T.to_torch_params({k: v for k, v in weights["seg"].items()
                            if "running" in k or "batch_norm" in k},
                           "bfloat16")
    assert "head.head.1.running_var" in bn and all(
        v.dtype == torch.bfloat16 for v in bn.values())
    x = _nchw(IMG, torch.bfloat16)
    with torch.no_grad():
        got = T._dpt_trunk(p, x)[0].permute(1, 2, 0).float().numpy()
        out = T.dpt_forward(p, x)
    rel = _rel_to_max(got, want)
    assert rel < 6e-2, rel                                 # measured 1.9e-2
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
