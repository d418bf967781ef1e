"""Do the port's own training draws follow the JAX package's laws?  Over
``STEPS`` train steps at ``scripts/quality_seeds.py``'s cut point, the
draws each trainer makes for a step (the port:
``ops/rays.py::draw_train_randomness`` from
``train/__main__.py::step_generator(seed, step)``; the JAX package:
``build_train_rays``'s key splits of ``fold_in(PRNGKey(seed), step)``)
are pooled and held against each other with two-sample tests:

- the patch centres drawn from a confidence map (a seeded smooth field,
  some pixels 0): the picked pixels' counts over 8x12 cells, chi-square;
- the in-cell shifts: counts of 0..patch_size-1, chi-square;
- the uniform rays' xs and ys: counts per column and row, chi-square;
- the depth jitter: Kolmogorov-Smirnov over the first 16 rays' values;

and the sparse-depth picks, which each package's dataset makes from
(seed, epoch, index): every train sample's ``sparse_coords`` and
``sparse_mask`` of ``EPOCHS`` epochs, bit for bit.

The port's draws come from the device they are made on, so the card's
are dumped there and compared here:

    # on the card (imports no JAX)
    python3 scripts/draw_laws.py --dump chiprun_out/draws_card.npz \\
        --device cuda
    # here, with the JAX package on the CPU
    JAX_PLATFORMS=cpu python scripts/draw_laws.py \\
        --compare chiprun_out/draws_card.npz

Without ``--compare`` a dump is made on this machine's device first.
Prints one JSON line: each test's statistic and p-value.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from quality_seeds import CUT  # noqa: E402

CELLS = (8, 12)
JITTER_RAYS = 16
STEPS = 1000
EPOCHS = 5          # of sparse-depth picks compared


def cut_config():
    from ucnerf_torch.config import parse_config
    return parse_config([a for a in CUT if a not in ("--steps_per_dispatch",
                                                     "1")])


def confidence_map(H: int, W: int) -> np.ndarray:
    """A seeded smooth confidence in [0, 1] with a block of zeros (the
    cascade's confidence is clamped to [0, 1])."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    c = 0.5 + 0.4 * np.sin(x / 9.0) * np.cos(y / 7.0)
    c[: H // 8, : W // 8] = 0.0
    return c.astype(np.float32)


def _centres(gumbel: np.ndarray, conf: np.ndarray, k: int) -> np.ndarray:
    """Gumbel top-k over log(conf): the picks of both packages'
    ``gumbel_topk_sample`` (zero weights never picked)."""
    logw = np.where(conf > 0, np.log(np.maximum(conf, 1e-30)), -np.inf)
    return np.argsort(-(logw.reshape(-1)[None] + gumbel), axis=-1)[:, :k]


def port_draws(seed: int, steps: int, device: str) -> dict:
    from ucnerf_torch.ops.rays import draw_train_randomness
    from ucnerf_torch.train.__main__ import step_generator
    cfg = cut_config()
    W, H = cfg.img_wh
    conf = confidence_map(H, W)
    out = {k: [] for k in ("centres", "shifts", "xs", "ys", "jitter")}
    for step in range(steps):
        d = draw_train_randomness(
            step_generator(seed, step, torch.device(device)), H=H, W=W,
            patch_size=cfg.patch_size, patch_num=cfg.patch_num,
            n_uniform=cfg.n_uniform_rays, n_rays=cfg.n_built_rays,
            n_samples=cfg.N_samples)
        v = {k: getattr(d, k).cpu().numpy() for k in d._fields}
        v["centres"] = _centres(v.pop("gumbel"), conf, cfg.patch_num // 2)
        v["jitter"] = v["jitter"][:JITTER_RAYS]
        for k in out:
            out[k].append(v[k])
    return {k: np.stack(v) for k, v in out.items()}


def jax_draws(seed: int, steps: int) -> dict:
    import jax
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_train_rays import _jax_draws
    cfg = cut_config()
    W, H = cfg.img_wh
    conf = confidence_map(H, W)
    key = jax.random.PRNGKey(seed)
    out = {k: [] for k in ("centres", "shifts", "xs", "ys", "jitter")}
    for step in range(steps):
        g, sh, xs, ys, jit = (np.asarray(a) for a in _jax_draws(
            jax.random.fold_in(key, step), H, W, cfg.patch_size,
            cfg.patch_num, cfg.n_uniform_rays, cfg.n_built_rays,
            cfg.N_samples))
        for k, v in zip(out, (_centres(g, conf, cfg.patch_num // 2), sh,
                              xs, ys, jit[:JITTER_RAYS])):
            out[k].append(v)
    return {k: np.stack(v) for k, v in out.items()}


def sparse_picks(seed: int, epochs: int) -> dict:
    """Every train sample's sparse-depth picks in both packages' datasets
    at the cut point: equal bit for bit?"""
    from ucnerf_torch.data import build_dataset
    from ucnerf_tpu.config import parse_config as j_parse_config
    from ucnerf_tpu.data import build_dataset as j_build_dataset
    argv = [a for a in CUT if a not in ("--steps_per_dispatch", "1")] + [
        "--seed", str(seed)]
    ds = build_dataset(cut_config().replace(seed=seed), "train")
    jds = j_build_dataset(j_parse_config(argv), "train")
    samples, differ = 0, 0
    for epoch in range(epochs):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(ds)):
            a, b = ds[i], jds[i]
            samples += 1
            differ += not (np.array_equal(a["sparse_coords"],
                                          b["sparse_coords"])
                           and np.array_equal(a["sparse_mask"],
                                              b["sparse_mask"]))
    return dict(samples=samples, differ=differ)


def _chi2(a: np.ndarray, b: np.ndarray) -> dict:
    from scipy.stats import chi2_contingency
    keep = (a + b) > 0
    stat, p, dof, _ = chi2_contingency(np.stack([a[keep], b[keep]]))
    return dict(stat=float(stat), p=float(p), dof=int(dof))


def compare(port: dict, jax_: dict) -> dict:
    from scipy.stats import ks_2samp
    cfg = cut_config()
    W, H = cfg.img_wh
    out = {}
    hists = []
    for d in (port, jax_):
        sel = d["centres"].ravel()
        cy = (sel // W) * CELLS[0] // H
        cx = (sel % W) * CELLS[1] // W
        hists.append(np.bincount(cy * CELLS[1] + cx,
                                 minlength=CELLS[0] * CELLS[1]))
    out["patch_centres"] = _chi2(*hists)
    out["shifts"] = _chi2(*(np.bincount(d["shifts"].ravel(),
                                        minlength=cfg.patch_size)
                            for d in (port, jax_)))
    out["uniform_xs"] = _chi2(*(np.bincount(d["xs"].ravel(), minlength=W)
                                for d in (port, jax_)))
    out["uniform_ys"] = _chi2(*(np.bincount(d["ys"].ravel(), minlength=H)
                                for d in (port, jax_)))
    r = ks_2samp(port["jitter"].ravel(), jax_["jitter"].ravel())
    out["jitter"] = dict(stat=float(r.statistic), p=float(r.pvalue),
                         n=int(port["jitter"].size))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--dump", help="write the port's draws to this npz")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--compare", help="the port's draws (an npz of --dump)")
    args = ap.parse_args(argv)
    if args.dump:
        np.savez(args.dump, device=str(args.device),
                 **port_draws(args.seed, STEPS, args.device))
        print(json.dumps(dict(dump=args.dump, steps=STEPS,
                              device=args.device)))
        return
    if args.compare:
        with np.load(args.compare) as f:
            port = {k: f[k] for k in f.files if k != "device"}
            device = str(f["device"])
    else:
        port, device = port_draws(args.seed, STEPS, args.device), \
            args.device
    res = compare(port, jax_draws(args.seed, len(port["xs"])))
    print(json.dumps(dict(res, port_device=device, steps=len(port["xs"]),
                          seed=args.seed,
                          sparse_picks=sparse_picks(args.seed, EPOCHS))))


if __name__ == "__main__":
    main()
