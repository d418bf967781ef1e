"""ucnerf_torch ops against the JAX package's on the same random inputs:
positional encoding, compositing, depth candidates, eval rays, resizes,
the plane-sweep warp + variance volume, the fast and the literal
featurization, and the colour volumes of ``--use_color_volume``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.models import mvs as j_mvs
from ucnerf_tpu.ops import composite as j_comp
from ucnerf_tpu.ops import interpolate as j_interp
from ucnerf_tpu.ops import pe as j_pe
from ucnerf_tpu.ops import rays as j_rays
from ucnerf_tpu.ops import sampling as j_samp
from ucnerf_tpu.ops import warp as j_warp
from ucnerf_tpu.render import fast_feats as j_ff
from ucnerf_tpu.render import renderer as j_renderer

from ucnerf_torch.models import mvs as t_mvs
from ucnerf_torch.ops import composite as t_comp
from ucnerf_torch.ops import interpolate as t_interp
from ucnerf_torch.ops import pe as t_pe
from ucnerf_torch.ops import rays as t_rays
from ucnerf_torch.ops import warp as t_warp
from ucnerf_torch.render import fast_feats as t_ff
from ucnerf_torch.render import renderer as t_renderer

torch.set_num_threads(1)

ATOL = 1e-5
H, W, V1, S = 16, 24, 3, 12
N_PLANES = 10          # colour-volume depth planes
# compile time, not run time, dominates these references on the CPU
JIT_QUICK = {"xla_backend_optimization_level": 0}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=msg)


def _camera(v):
    th = 0.04 * v
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                   [-np.sin(th), 0, np.cos(th)]]
    w2c[:3, 3] = [0.06 * v, -0.02 * v, 0.01 * v]
    return w2c


@pytest.fixture(scope="module")
def case():
    """Random inputs and every JAX output, computed once."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], f32)
    w2cs = np.stack([_camera(v) for v in range(V1 + 1)])
    c2ws = np.linalg.inv(w2cs).astype(f32)
    near, far = f32(0.8), f32(2.5)
    planes = {}
    for k, s in ((1, 4), (2, 2), (3, 1)):
        lo = rng.uniform(0.8, 1.4, (H // s, W // s)).astype(f32)
        planes[k] = (lo, (lo + rng.uniform(0.3, 1.0, lo.shape)).astype(f32))
    pix = rng.permutation(H * W)[:40].astype(np.int32)
    inp = dict(
        x=rng.standard_normal((5, 7, 3)).astype(f32),
        raw=rng.standard_normal((9, S, 4)).astype(f32),
        z=np.sort(rng.uniform(1, 3, (9, S)), -1).astype(f32),
        cos=rng.uniform(0.5, 1.0, 9).astype(f32),
        img=rng.standard_normal((H // 2, W // 2, 5)).astype(f32),
        vol=rng.standard_normal((6, H // 2, W // 2, 1)).astype(f32),
        feat=rng.standard_normal((V1, H, W, 8)).astype(f32),
        K=K, w2cs=w2cs, c2ws=c2ws, near=near, far=far, planes=planes,
        pix=pix, depth_vals=np.broadcast_to(
            np.linspace(0.9, 2.4, 8, dtype=f32)[:, None, None],
            (8, H + 2, W + 2)).copy(),
        volumes={k: rng.standard_normal((d, H // s, W // s, 8)).astype(f32)
                 for k, d, s in ((1, 8, 4), (2, 6, 2), (3, 4, 1))},
        conf=rng.uniform(0, 1, (H, W)).astype(f32),
        views=rng.uniform(0, 1, (V1, H, W, 11)).astype(f32))
    projs = []
    for v in range(V1):
        a, b = np.eye(4, dtype=f32), np.eye(4, dtype=f32)
        a[:3] = K @ w2cs[v + 1, :3]
        b[:3] = K @ w2cs[0, :3]
        projs.append((a @ np.linalg.inv(b))[:3])
    inp["projs"] = np.stack(projs).astype(f32)
    inp["jitter"] = np.asarray(jax.random.uniform(jax.random.PRNGKey(1),
                                                  (40, S)))

    Ks = np.broadcast_to(K, (V1, 3, 3))

    # every reference traced and compiled as one function: op-by-op
    # dispatch compiles every op on its own, and each jit has its cost
    def refs(inp):
        j = {}
        j["pe"] = j_pe.positional_encoding(inp["x"], 4)
        j["composite"] = j_comp.raw2outputs(inp["raw"], inp["z"], True)
        j["dist"] = j_comp.depth2dist(inp["z"], inp["cos"])
        j["bilinear"] = j_interp.resize_bilinear(inp["img"], (H, W))
        j["trilinear"] = j_interp.resize_trilinear(inp["vol"], (4, H, W))
        j["nearest"] = j_interp.upsample2x_nearest(inp["img"])
        j["rays"] = rays = j_rays.build_test_rays(
            inp["pix"], H=H, W=W, n_samples=S, intrinsic=K, c2w=c2ws[0],
            w2c_ref=w2cs[0], intrinsic_ref=K, near_ref=near, far_ref=far,
            stage_planes=inp["planes"])
        j["cands"] = j_samp.stratified_jitter(j_samp.stage_depth_candidates(
            rays["stage_near_far"], S), jax.random.PRNGKey(1))
        j["warp"] = j_warp.homo_warp(inp["feat"][0], inp["projs"][0],
                                     inp["depth_vals"], pad=1)
        j["variance"] = j_mvs._variance_cost_volume(
            inp["feat"], inp["projs"], inp["depth_vals"], pad=1)
        j["point_feats"] = j_ff.index_point_feature_fast(
            inp["volumes"], inp["conf"], rays)
        quads = j_ff.pack_quads(inp["views"])
        j["colors"] = j_ff.build_color_volume_fast(
            rays["points_world"], w2cs[1:], Ks, quads, (H, W))
        mvs_out = {f"stage{k}": {"volume_feature": v}
                   for k, v in inp["volumes"].items()}
        mvs_out["img_feats"] = inp["views"][..., 3:]
        j["literal"] = j_renderer.gen_pts_feats(
            rays, mvs_out, inp["conf"], inp["views"][..., :3], w2cs[1:], Ks)
        j["volumes"] = j_ff.build_color_volumes(
            quads, w2cs[1:], Ks, c2ws[0], K, near, far, (H, W), N_PLANES)
        j["volume_feats"] = j_ff.sample_color_volumes_per_ray(
            j["volumes"], rays, near, far, (H, W), 8)
        return j
    j = jax.jit(refs, compiler_options=JIT_QUICK)(
        {k: v for k, v in inp.items() if k not in ("K", "near", "far")})
    return inp, jax.tree.map(np.asarray, j)


def _rays(inp, jitter_u=None):
    planes = {k: (_t(a), _t(b)) for k, (a, b) in inp["planes"].items()}
    return t_rays.build_test_rays(
        _t(inp["pix"]).long(), H=H, W=W, intrinsic=_t(inp["K"]),
        c2w=_t(inp["c2ws"][0]), near_ref=_t(inp["near"]),
        far_ref=_t(inp["far"]), stage_planes=planes, n_samples=S,
        jitter_u=jitter_u)


def test_positional_encoding(case):
    inp, j = case
    _close(t_pe.positional_encoding(_t(inp["x"]), 4), j["pe"])


def test_composite(case):
    inp, j = case
    got = t_comp.raw2outputs(_t(inp["raw"]), _t(inp["z"]), True)
    for g, w in zip(got, j["composite"]):
        _close(g, w)
    _close(t_comp.depth2dist(_t(inp["z"]), _t(inp["cos"])), j["dist"])


def test_resizes(case):
    inp, j = case
    _close(t_interp.resize_bilinear(_t(inp["img"]), (H, W)), j["bilinear"])
    _close(t_interp.resize_trilinear(_t(inp["vol"]), (4, H, W)),
           j["trilinear"])
    np.testing.assert_array_equal(
        t_interp.upsample2x_nearest(_t(inp["img"])).numpy(), j["nearest"])


def test_build_test_rays(case):
    inp, j = case
    got = _rays(inp)
    for key in ("rays_o", "rays_d", "depth_candidates", "points_world"):
        _close(got[key], j["rays"][key], msg=key)
    np.testing.assert_array_equal(got["pixel_coords"].numpy(),
                                  j["rays"]["pixel_coords"])
    for key, val in j["rays"]["ndc"].items():
        _close(got["ndc"][key], val, msg=key)


def test_stage_depth_candidates_jitter(case):
    """The jitter's uniform draws come in as a tensor: fed JAX's draws,
    the port's jittered candidates equal JAX's."""
    inp, j = case
    got = _rays(inp, jitter_u=_t(inp["jitter"]))
    _close(got["depth_candidates"], j["cands"])


def test_homo_warp_and_variance(case):
    inp, j = case
    warped, mask = t_warp.homo_warp(_t(inp["feat"][0]), _t(inp["projs"][0]),
                                    _t(inp["depth_vals"]), pad=1)
    np.testing.assert_array_equal(mask.numpy(), j["warp"][1])
    assert 0 < mask.numpy().mean() < 1   # both in- and out-of-bounds
    _close(warped, j["warp"][0])
    var = t_mvs._variance_cost_volume(_t(inp["feat"]), _t(inp["projs"]),
                                      _t(inp["depth_vals"]), pad=1)
    _close(var, j["variance"])


def test_fast_featurization(case):
    inp, j = case
    rays = _rays(inp)
    vols = {k: _t(v) for k, v in inp["volumes"].items()}
    feats, conf = t_ff.index_point_feature_fast(vols, _t(inp["conf"]), rays)
    _close(feats, j["point_feats"][0])
    _close(conf, j["point_feats"][1])
    colors = t_ff.build_color_volume_fast(
        rays["points_world"], _t(inp["w2cs"][1:]),
        _t(np.broadcast_to(inp["K"], (V1, 3, 3))), _t(inp["views"]), (H, W))
    assert colors.shape == j["colors"].shape
    _close(colors, j["colors"])


def test_literal_featurization(case):
    """``fast_featurization`` false: the literal feature tensor (per-point
    trilinear lookups of the stage volumes, the confidence at the stage-3
    xy, each point reprojected into each source view) against the JAX
    package's ``gen_pts_feats``, to 1e-5 of its largest value."""
    inp, j = case
    rays = _rays(inp)
    views = _t(inp["views"])
    mvs_out = {f"stage{k}": {"volume_feature": _t(v)}
               for k, v in inp["volumes"].items()}
    mvs_out["img_feats"] = views[..., 3:]
    ctx = t_renderer.make_feat_ctx(
        mvs_out, _t(inp["conf"]), views[..., :3], _t(inp["w2cs"][1:]),
        _t(np.broadcast_to(inp["K"], (V1, 3, 3))))
    got = t_renderer.gen_pts_feats(rays, ctx).numpy()
    want = j["literal"]
    assert got.shape == want.shape == (40, S, 24 + 12 * V1 + 1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the in-bounds masks: both in and out of the source views
    masks = want[..., 24 + 3:24 + 4 * V1:4]
    assert 0 < masks.mean() < 1
    np.testing.assert_array_equal(got[..., 24 + 3:24 + 4 * V1:4], masks)


def test_color_volumes(case):
    """``--use_color_volume``: the per-frame volumes (every source view at
    N_PLANES depth planes of every target pixel, rgb | features | mask)
    and their per-ray reads against the JAX package's
    ``build_color_volumes`` / ``sample_color_volumes_per_ray`` (the JAX
    read is a one-hot einsum, the port's a gather and a lerp: equal up to
    round-off)."""
    inp, j = case
    rays = _rays(inp)
    vols = t_ff.build_color_volumes(
        _t(inp["views"]), _t(inp["w2cs"][1:]),
        _t(np.broadcast_to(inp["K"], (V1, 3, 3))), _t(inp["c2ws"][0]),
        _t(inp["K"]), _t(inp["near"]), _t(inp["far"]), N_PLANES)
    assert vols.shape == j["volumes"].shape == (V1, H * W, N_PLANES, 12)
    _close(vols, j["volumes"])
    got = t_ff.sample_color_volumes_per_ray(vols, rays, _t(inp["near"]),
                                            _t(inp["far"]), (H, W))
    assert got.shape == j["volume_feats"].shape == (40, S, 12 * V1)
    _close(got, j["volume_feats"])
