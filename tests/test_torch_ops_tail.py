"""The ops tail of ucnerf_torch against the JAX package's on the same
random inputs (rtol 1e-5): geometry (``skew``, the so(3) / SE(3)
exponentials with their small-angle Taylor guards, pixel <-> world),
``world_to_ref_ndc``, ``sample_pdf``, the latent ray APIs, the latent
losses and ``checked``.  Draws are JAX's, passed to the port as tensors."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.ops import geometry as j_geo
from ucnerf_tpu.ops import ndc as j_ndc
from ucnerf_tpu.ops import rays as j_rays
from ucnerf_tpu.ops import sampling as j_samp
from ucnerf_tpu.train import losses as j_loss
from ucnerf_tpu.utils import profiling as j_prof

from ucnerf_torch.ops import geometry as t_geo
from ucnerf_torch.ops import ndc as t_ndc
from ucnerf_torch.ops import rays as t_rays
from ucnerf_torch.ops import sampling as t_samp
from ucnerf_torch.train import losses as t_loss
from ucnerf_torch.utils import profiling as t_prof

torch.set_num_threads(1)

# compile time, not run time, dominates these references on the CPU
JIT_QUICK = {"xla_backend_optimization_level": 0}
N_PDF, N_MARCH, N_FINE = 7, 8, 5
KEY = jax.random.PRNGKey(7)


def _inputs():
    rng = np.random.default_rng(11)
    f32 = np.float32
    rot = rng.normal(0, 0.5, (6, 3)).astype(f32)
    rot[0] = 0.0                          # the Taylor guards' branch
    rot[1] = [3e-9, -2e-9, 1e-9]
    K = np.array([[40.0, 0, 16.0], [0, 42.0, 12.0], [0, 0, 1]], f32)
    pose = np.eye(4, dtype=f32)
    pose[:3, :4] = np.asarray(j_geo.se3_exp(jnp.asarray(
        [0.1, -0.05, 0.2, 0.3, -0.1, 0.05], jnp.float32)))
    near = rng.uniform(0.5, 1.0, (4, 1)).astype(f32)
    bins = np.sort(rng.uniform(1, 3, (6, 9)), -1).astype(f32)
    o = rng.normal(0, 0.1, (5, 3)).astype(f32)
    d = rng.normal(0, 1, (5, 3)).astype(f32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    return dict(
        v=rng.standard_normal((5, 3)).astype(f32), w=rot,
        wu=np.concatenate([rot, rng.normal(0, 1, (6, 3)).astype(f32)], -1),
        pixels=rng.uniform(0, 32, (7, 2)).astype(f32),
        depth=rng.uniform(0.5, 3, (7,)).astype(f32), K=K, c2w=pose,
        w2c=np.linalg.inv(pose).astype(f32),
        points=(rng.normal(0, 0.3, (4, 5, 3)) + [0, 0, 2]).astype(f32),
        inv_scale=np.array([31.0, 23.0], f32),
        snf={"near_1": near, "far_1": near + 2.0, "near_2": near + 0.2,
             "far_2": near + 1.5, "near_3": near + 0.4, "far_3": near + 1.0,
             "near": f32(0.5), "far": f32(3.0)},
        bins=bins, weights=rng.uniform(0, 1, (6, 8)).astype(f32),
        rays_o=o, rays_d=d, bbox=np.array([[-1, -1, -3], [1, 1, -0.5]], f32),
        rays=np.concatenate([o, d, np.full((5, 1), 0.5, f32),
                             np.full((5, 1), 3.0, f32)], -1),
        coarse_w=rng.uniform(0, 1, (5, N_MARCH)).astype(f32),
        pred=rng.uniform(0.5, 3, (6, 4)).astype(f32),
        gt=rng.uniform(0.5, 3, (6, 4)).astype(f32),
        mask=(rng.uniform(size=(6, 4)) < 0.5).astype(f32))


def _refs(a):
    """Every JAX reference, with the draws each one makes."""
    k1, k2, k3 = jax.random.split(KEY, 3)
    z = jnp.linspace(0.5, 3.0, N_MARCH)
    marched = j_rays.ray_marcher(a["rays"], N_MARCH, perturb=1.0, key=k2)
    return {
        "skew": j_geo.skew(a["v"]),
        "so3_exp": j_geo.so3_exp(a["w"]),
        "se3_exp": j_geo.se3_exp(a["wu"]),
        "transform_to_world": j_geo.transform_to_world(
            a["pixels"], a["depth"], a["K"], a["c2w"]),
        "project_to_cam": j_geo.project_to_cam(a["points"], a["K"],
                                               a["w2c"]),
        "reproject": j_geo.reproject(a["pixels"], a["depth"], a["K"],
                                     a["c2w"], a["w2c"]),
        "world_to_ref_ndc": j_ndc.world_to_ref_ndc(
            a["points"], a["w2c"], a["K"], a["inv_scale"], a["snf"]),
        "sample_pdf": (j_samp.sample_pdf(a["bins"], a["weights"], N_PDF,
                                         key=k1),
                       jax.random.uniform(k1, (6, N_PDF))),
        "sample_pdf_det": j_samp.sample_pdf(a["bins"], a["weights"], N_PDF,
                                            det=True),
        "get_ndc_rays": j_rays.get_ndc_rays(24, 32, (40.0, 42.0), 0.5,
                                            a["rays_o"], a["rays_d"]),
        "ray_aabb": j_rays.ray_aabb(a["rays_o"], a["rays_d"], a["bbox"]),
        "ray_marcher": (marched,
                        jax.random.uniform(k2, (5, N_MARCH))),
        "ray_marcher_lindisp": j_rays.ray_marcher(a["rays"], N_MARCH,
                                                  lindisp=True),
        "ray_marcher_fine": (j_rays.ray_marcher_fine(
            a["rays"], jnp.broadcast_to(z, (5, N_MARCH)), a["coarse_w"],
            N_FINE, key=k3), jax.random.uniform(k3, (5, N_FINE))),
        "sl1_loss": j_loss.sl1_loss(a["pred"], a["gt"]),
        "sl1_loss_mask": j_loss.sl1_loss(a["pred"], a["gt"], a["mask"]),
        "compute_depth_loss": j_loss.compute_depth_loss(a["pred"], a["gt"]),
        "con_cal": j_loss.con_cal(a["pred"], a["gt"]),
    }


@pytest.fixture(scope="module")
def case():
    a = _inputs()
    j = jax.jit(_refs, compiler_options=JIT_QUICK)(
        jax.tree.map(jnp.asarray, a))
    return a, jax.tree.map(np.asarray, j)


def _ports(name, a):
    """The port's output for case ``name``, and the JAX draws it takes."""
    t = {k: (jax.tree.map(lambda x: torch.from_numpy(np.array(x)), v))
         for k, v in a.items()}
    z = torch.linspace(0.5, 3.0, N_MARCH)
    return {
        "skew": lambda _: t_geo.skew(t["v"]),
        "so3_exp": lambda _: t_geo.so3_exp(t["w"]),
        "se3_exp": lambda _: t_geo.se3_exp(t["wu"]),
        "transform_to_world": lambda _: t_geo.transform_to_world(
            t["pixels"], t["depth"], t["K"], t["c2w"]),
        "project_to_cam": lambda _: t_geo.project_to_cam(
            t["points"], t["K"], t["w2c"]),
        "reproject": lambda _: t_geo.reproject(
            t["pixels"], t["depth"], t["K"], t["c2w"], t["w2c"]),
        "world_to_ref_ndc": lambda _: t_ndc.world_to_ref_ndc(
            t["points"], t["w2c"], t["K"], t["inv_scale"], t["snf"]),
        "sample_pdf": lambda u: t_samp.sample_pdf(t["bins"], t["weights"],
                                                  N_PDF, u=u),
        "sample_pdf_det": lambda _: t_samp.sample_pdf(
            t["bins"], t["weights"], N_PDF),
        "get_ndc_rays": lambda _: t_rays.get_ndc_rays(
            24, 32, (40.0, 42.0), 0.5, t["rays_o"], t["rays_d"]),
        "ray_aabb": lambda _: t_rays.ray_aabb(t["rays_o"], t["rays_d"],
                                              t["bbox"]),
        "ray_marcher": lambda u: t_rays.ray_marcher(t["rays"], N_MARCH,
                                                    perturb=1.0, u=u),
        "ray_marcher_lindisp": lambda _: t_rays.ray_marcher(
            t["rays"], N_MARCH, lindisp=True),
        "ray_marcher_fine": lambda u: t_rays.ray_marcher_fine(
            t["rays"], z.expand(5, N_MARCH), t["coarse_w"], N_FINE, u=u),
        "sl1_loss": lambda _: t_loss.sl1_loss(t["pred"], t["gt"]),
        "sl1_loss_mask": lambda _: t_loss.sl1_loss(t["pred"], t["gt"],
                                                   t["mask"]),
        "compute_depth_loss": lambda _: t_loss.compute_depth_loss(
            t["pred"], t["gt"]),
        "con_cal": lambda _: t_loss.con_cal(t["pred"], t["gt"]),
    }[name]


DRAWN = ("sample_pdf", "ray_marcher", "ray_marcher_fine")


@pytest.mark.parametrize("name", [
    "skew", "so3_exp", "se3_exp", "transform_to_world", "project_to_cam",
    "reproject", "world_to_ref_ndc", "sample_pdf", "sample_pdf_det",
    "get_ndc_rays", "ray_aabb", "ray_marcher", "ray_marcher_lindisp",
    "ray_marcher_fine", "sl1_loss", "sl1_loss_mask", "compute_depth_loss",
    "con_cal", "checked"])
def test_ops_tail_matches_jax(case, name):
    a, j = case
    if name == "checked":
        # a NaN made by an op raises (the port names the op); a clean call
        # returns the wrapped function's value
        x = np.array([1.0, 4.0], np.float32)
        got = t_prof.checked(lambda v: torch.log(v) * 2)(torch.from_numpy(x))
        j_fn = jax.jit(lambda v: jnp.log(v) * 2)
        want = j_prof.checked(j_fn)(jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        with pytest.raises(FloatingPointError, match="log"):
            t_prof.checked(lambda v: torch.log(v) * 2)(-torch.from_numpy(x))
        with pytest.raises(Exception, match="nan"):
            j_prof.checked(j_fn)(-jnp.asarray(x))
        return
    want, u = j[name] if name in DRAWN else (j[name], None)
    got = _ports(name, a)(None if u is None else torch.from_numpy(
        np.array(u)))
    got = jax.tree.map(lambda t: t.detach().numpy(), got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, w, rtol=1e-5, atol=1e-6, err_msg=name), got, want)


def test_se3_exp_gradient_near_zero():
    """The Taylor guards keep the exponential's gradient finite at a zero
    rotation (sin(x)/x would be 0/0 there), and it equals JAX's at a small
    one.  At exactly zero JAX's is NaN (the norm's derivative), the
    port's 0: torch's norm takes the subgradient there."""
    def port_grad(v):
        w = torch.from_numpy(v).requires_grad_()
        t_geo.se3_exp(torch.cat([w, torch.ones((2, 3))], -1)).sum().backward()
        return w.grad.numpy()
    assert np.isfinite(port_grad(np.zeros((2, 3), np.float32))).all()
    small = np.full((2, 3), 1e-3, np.float32)
    want = jax.jit(jax.grad(lambda v: j_geo.se3_exp(jnp.concatenate(
        [v, jnp.ones((2, 3))], -1)).sum()))(jnp.asarray(small))
    np.testing.assert_allclose(port_grad(small), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
