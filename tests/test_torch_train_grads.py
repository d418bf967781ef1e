"""The train step's loss and its 154 gradients against the JAX package's
``jax.value_and_grad`` of ``scene_loss``, at the small shape and seeded
weights of ``tests/test_torch_train.py`` with JAX's ray draws, through the
fast and the literal featurization (the float32 MLP; the bf16 step is in
``tests/test_torch_train_bf16.py``).  Two tests, so that pytest-xdist's
``--dist loadfile`` queues this file after the suite's long JAX files."""

import jax
import numpy as np
import torch

from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train import loop as t_loop
from ucnerf_torch.utils.checkpoint_io import state_dict_from_jax

from test_torch_train import (SCENE_REFS, _draws, _grads,  # noqa: F401
                              _port, _rel_envelope, case, jax_scene_refs)

torch.set_num_threads(1)


def _check_scene_loss_and_gradients(case, name: str):
    """The port's ``scene_loss`` and gradients at SCENE_REFS[name] against
    ``jax_scene_refs(("fast", "literal"))[name]``, with JAX's draws."""
    flags, seed, _ = SCENE_REFS[name]
    cfg = case["cfg"].replace(**flags)
    (_, terms_j), grads_j = jax_scene_refs(("fast", "literal"))[name]
    nerf, mvs = _port(cfg, case["params"])
    loss, terms = t_loop.scene_loss(cfg, nerf, mvs,
                                    to_device_batch(case["sample"], "cpu"),
                                    _draws(cfg, jax.random.PRNGKey(seed)))
    loss.backward()
    for name in terms_j:
        np.testing.assert_allclose(float(terms[name].detach()),
                                   float(terms_j[name]), rtol=6e-3,
                                   err_msg=name)
    want = state_dict_from_jax(grads_j)
    want = {**want["nerf"], **want["mvs"]}
    got = _grads(nerf, mvs)
    assert sorted(got) == sorted(want) and len(want) == 154
    assert all(g is not None for g in got.values())
    rels = _rel_envelope(got, want)
    worst = max(rels, key=rels.get)
    med = float(np.median(list(rels.values())))
    assert med < 5e-3, f"median gradient rel {med:.2e}"
    assert rels[worst] < 3e-2, f"gradient mismatch {worst}: {rels[worst]:.2e}"


def test_scene_loss_and_gradients_match_jax(case):
    """``scene_loss`` with pinned draws against ``jax.value_and_grad`` of
    the JAX package's, over all 154 gradient tensors mapped through the
    weight bridge.  The envelope of ``tests/test_loss_parity.py``: terms
    rtol 6e-3; per-tensor rel (max abs diff / max abs) median < 5e-3 and
    worst < 3e-2.  float32 MLP: the bf16 step has its own envelope
    (``tests/test_torch_train_bf16.py``)."""
    _check_scene_loss_and_gradients(case, "fast")


def test_literal_scene_loss_and_gradients_match_jax(case):
    """``fast_featurization`` false: the train step's loss and its 154
    gradients through the literal featurization (per-point trilinear and
    bilinear lookups, ``render/renderer.py::gen_pts_feats``) against
    ``jax.value_and_grad`` of the JAX package's literal path, in the same
    envelope."""
    _check_scene_loss_and_gradients(case, "literal")
