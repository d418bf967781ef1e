"""Other roundings of ucnerf_torch's plain bf16 MLP, for measuring how far
its train step's gradients are from the JAX train step's.

The port's plain MLP (``ucnerf_torch/models/nerf.py``) rounds as the fused
kernel does: one rounding after the f32 bias add (forward ``"kernel"``),
and autograd through f32 operations on bf16 values, rounding only at the
next forward rounding (backward ``"autograd"``).  That is ``KERNEL``, what
every render and the train step run.  The JAX train step runs flax's
``nn.Dense(dtype=bfloat16)`` and XLA's autodiff of it instead.
``rounding(mlp, forward, backward)`` gives the MLP, within a block, the
forward rounding ``"kernel"`` or ``"flax"`` (the product, the bias and
their sum each to bf16) and the backward ``"autograd"`` or ``"xla"``: the
activations are bf16 tensors, so the bias products' cotangents and the
fan-out sums of a bf16 activation's cotangent round to bf16 as in XLA,
and ``RoundedDense`` rounds the input, weight and bias cotangents to bf16
after an f32 accumulation.  No arm other than ``KERNEL`` brings the step's
gradients nearer the JAX step's (PERF.md §6), so none is in the port.

Imports neither JAX nor the tests' conftest: ``torch_parallel_worker``'s
ranks import it too.
"""

from __future__ import annotations

import contextlib
import types

import torch
import torch.nn.functional as F

KERNEL = ("kernel", "autograd")


class RoundedDense(torch.autograd.Function):
    """``x @ W.T + b`` as XLA computes flax's ``nn.Dense(dtype)`` on the
    CPU and its transpose: the operands rounded to ``dtype``, the product
    accumulated in f32; forward ``"flax"``: the product, the bias and their
    sum rounded, ``"kernel"``: one rounding after the f32 bias add.  The
    output is a ``dtype`` tensor.  Backward: the output cotangent at
    ``dtype``; the input's ``dtype(g @ W)``, given back at the input's
    dtype; the weight's ``dtype(g.T @ x)`` and the bias's ``dtype(sum g)``,
    each accumulated in f32 and given back in f32."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype, forward):
        xq, wq = x.to(dtype), weight.to(dtype)
        y = F.linear(xq.float(), wq.float())
        if forward == "flax":
            y = y.to(dtype).float() + bias.to(dtype).float()
        else:
            y = y + bias
        ctx.save_for_backward(xq, wq)
        ctx.dtype, ctx.x_dtype = dtype, x.dtype
        return y.to(dtype)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        g = g.to(ctx.dtype).float()
        gx = (g @ wq.float()).to(ctx.dtype).to(ctx.x_dtype)
        g2 = g.reshape(-1, g.shape[-1])
        gw = (g2.T @ xq.float().reshape(-1, xq.shape[-1])).to(ctx.dtype)
        gb = g2.sum(0).to(ctx.dtype)
        return gx, gw.float(), gb.float(), None, None


def _flax_dense(self, x, layer):
    r = self._round
    return r(r(F.linear(x, r(layer.weight))) + r(layer.bias))


def _keep(self, x):
    # "xla": the bf16 operations make bf16 tensors, and each dense layer
    # rounds its own input
    return x


def _xla_dense(forward):
    def dense(self, x, layer):
        return RoundedDense.apply(x, layer.weight, layer.bias, self.dtype,
                                  forward)
    return dense


@contextlib.contextmanager
def rounding(mlp, forward: str = "kernel", backward: str = "autograd"):
    """Within the block the plain MLP ``mlp`` (a ``UCNeRFMLP``) rounds as
    (forward, backward) say (module docstring); a float32 MLP does not
    round, and ``KERNEL`` is the MLP as it stands."""
    nerf = mlp.nerf
    patch = {}
    if nerf.dtype is not None and backward == "xla":
        patch = dict(_round=_keep, _dense=_xla_dense(forward))
    elif nerf.dtype is not None and forward == "flax":
        patch = dict(_dense=_flax_dense)
    for name, fn in patch.items():
        object.__setattr__(nerf, name, types.MethodType(fn, nerf))
    try:
        yield
    finally:
        for name in patch:
            del nerf.__dict__[name]
