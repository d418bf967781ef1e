"""Geometry helpers: the so(3) / SE(3) exponential maps with their Taylor
guards near zero, and pixel <-> world transforms.  Pure, differentiable
torch; the port of the JAX package's ``ops/geometry.py`` (a latent
capability of the reference, usable for pose refinement)."""

from __future__ import annotations

import torch

_EPS = 1e-8


def skew(v):
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1)], dim=-2)


def _taylor(x, near_zero, exact, denom):
    """``near_zero(x)`` where |x| < 1e-8, else ``exact(x) / denom(x)``
    (the denominator replaced by 1 where it is not used, so that neither
    branch's gradient is NaN)."""
    small = torch.abs(x) < _EPS
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, near_zero(x), exact(safe) / denom(safe))


def _taylor_A(x):   # sin(x)/x
    return _taylor(x, lambda t: 1.0 - t * t / 6.0, torch.sin, lambda t: t)


def _taylor_B(x):   # (1-cos(x))/x^2
    return _taylor(x, lambda t: 0.5 - t * t / 24.0,
                   lambda t: 1.0 - torch.cos(t), lambda t: t * t)


def _taylor_C(x):   # (x-sin(x))/x^3
    return _taylor(x, lambda t: 1.0 / 6.0 - t * t / 120.0,
                   lambda t: t - torch.sin(t), lambda t: t * t * t)


def _rotation_terms(w):
    theta = torch.linalg.norm(w, dim=-1)
    W = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return theta, W, W @ W, eye


def so3_exp(w):
    """so(3) exponential: [..., 3] -> [..., 3, 3] (Rodrigues)."""
    theta, W, W2, eye = _rotation_terms(w)
    return (eye + _taylor_A(theta)[..., None, None] * W
            + _taylor_B(theta)[..., None, None] * W2)


def se3_exp(wu):
    """se(3) exponential: [..., 6] (w, u) -> [..., 3, 4] c2w."""
    w, u = wu[..., :3], wu[..., 3:]
    theta, W, W2, eye = _rotation_terms(w)
    A = _taylor_A(theta)[..., None, None]
    B = _taylor_B(theta)[..., None, None]
    C = _taylor_C(theta)[..., None, None]
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    t = (V @ u[..., None])[..., 0]
    return torch.cat([R, t[..., None]], dim=-1)


def transform_to_world(pixels, depth, intrinsic, c2w):
    """Pixel coords [..., 2] + depth [...] -> world points [..., 3]."""
    pix_h = torch.cat([pixels, torch.ones_like(pixels[..., :1])], dim=-1)
    cam = (pix_h @ torch.linalg.inv(intrinsic).T) * depth[..., None]
    return cam @ c2w[:3, :3].T + c2w[:3, 3]


def project_to_cam(points, intrinsic, w2c):
    """World points [..., 3] -> (pixel [..., 2], camera z [...])."""
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    pix = cam @ intrinsic.T
    return pix[..., :2] / torch.clamp(pix[..., 2:], min=1e-8), cam[..., 2]


def reproject(pixels, depth, intrinsic, c2w_src, w2c_dst):
    """Lift pixels of the source view by their depth and project them into
    the destination view."""
    world = transform_to_world(pixels, depth, intrinsic, c2w_src)
    return project_to_cam(world, intrinsic, w2c_dst)
