"""Export the weights of a JAX run's orbax checkpoint to the '/'-keyed
params ``.npz`` that ``ucnerf_torch`` reads (``--ckpt params.npz``).

    JAX_PLATFORMS=cpu python scripts/export_params_npz.py \
        logs/scared/ckpts/step_00005000 params.npz [the run's config flags]

With ``init`` in place of the checkpoint it exports the weights the JAX
trainer starts from at ``--seed`` (``init_params(cfg, PRNGKey(seed),
(H, W))``, as ``train.py`` draws them):

    JAX_PLATFORMS=cpu python scripts/export_params_npz.py init \
        seed7.npz --seed 7 [the run's config flags]

The run's flags (``--preset``, ``--view_num``, ``--netwidth``, ...) shape
the target tree, which the JAX package's ``init_params`` builds (traced
only, nothing is drawn); ``ucnerf_tpu.utils.checkpoint_io.load_params``
then restores the checkpoint's ``params`` subtree into it, and
``save_params_npz`` writes it.  Needs jax, flax and orbax: run it where
the JAX package trains, not on a machine that has only the port.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from ucnerf_tpu.config import parse_config
from ucnerf_tpu.models.factory import init_params
from ucnerf_tpu.utils.checkpoint_io import load_params, save_params_npz

# the dummy image size init_params traces the cascade at; no weight's
# shape depends on it
_TRACE_HW = (32, 32)


def export_init(out: str, cfg) -> str:
    """The JAX trainer's initial weights at ``cfg.seed`` -> ``out``."""
    H, W = cfg.img_wh[1], cfg.img_wh[0]
    params = init_params(cfg, jax.random.PRNGKey(cfg.seed), (H, W))
    return save_params_npz(jax.tree.map(np.asarray, params), out)


def export(ckpt: str, out: str, cfg) -> str:
    """The ``params`` subtree of the orbax checkpoint ``ckpt`` -> ``out``."""
    shapes = jax.eval_shape(lambda: init_params(
        cfg, jax.random.PRNGKey(cfg.seed), _TRACE_HW))
    target = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = load_params(ckpt, target)
    return save_params_npz(jax.tree.map(np.asarray, params), out)


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("ckpt", help="orbax checkpoint directory "
                        "(<run>/ckpts/step_XXXXXXXX), or 'init'")
    parser.add_argument("out", help="the params .npz to write")
    ns, rest = parser.parse_known_args(argv)
    cfg = parse_config(rest)
    path = (export_init(ns.out, cfg) if ns.ckpt == "init"
            else export(ns.ckpt, ns.out, cfg))
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
