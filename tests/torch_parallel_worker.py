"""The rank side of ``tests/test_torch_parallel*.py``: functions a spawned
rank runs through ``ucnerf_torch.parallel.launch.run_ranks``.  A rank
imports this module, so it imports neither JAX nor the tests' conftest,
and pytest does not collect it.

``run_jobs(mesh, jobs)`` runs each job on every rank and returns rank 0's
results (numpy), the other ranks None.  A job is a dict with ``kind``:

- ``loss``: one multi-rank train step's loss of ``parallel_mode``
  (``argv``), backward and the gradient mean over the ranks; ``samples``
  and ``draws`` hold one numpy sample and one draw tuple per scene slot,
  ``relu``, when given, the ReLU choices the plain MLP takes
  (``relu_choices``), and ``rounding``, when given, the (forward,
  backward) rounding of the bf16 MLP in the step
  (``bf16_rounding.py``).  Result: the metrics and the gradients by
  state-dict name.
- ``cascade``: the view-sharded cascade's outputs on ``sample``, over
  the first ``ranks`` ranks.
- ``render``: the sharded eval render (through the fused-MLP wrapper) of
  ``sample``.
- ``train``: ``python -m ucnerf_torch.train``'s ``main(argv)`` on the
  rank, once per argv of ``runs``, in order (the rank's mesh stands in
  for the self-spawn).
- ``http``: serve's HTTP mode on the mesh: rank 0 runs
  ``make_http_server`` (``probe_timeout``) over a ``MeshLeader`` on a
  free port in a thread and asks it ``requests`` (a list of (method,
  path, body); a method ``WAIT GET`` repeats the request until it gets
  200, for at most 30 s), then shuts every rank down; the other ranks
  sleep ``stall_s`` and then run ``serve.follow``.  Rank 0's result: each
  answer's (status, body bytes, seconds), the single-device frame of
  ``c2w`` (npz bytes), and the count of renders rank 0 sent.

``hang(mesh)`` never returns: the launcher's time limit must end it.
"""

from __future__ import annotations

import contextlib
import threading
import time
import urllib.error
import urllib.request

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ucnerf_torch import serve
from ucnerf_torch.config import parse_config
from ucnerf_torch.kernels.fused_mlp import render_mlp
from ucnerf_torch.models import nerf as nerf_module
from ucnerf_torch.models.factory import create_models
from ucnerf_torch.ops.rays import TrainDraws
from ucnerf_torch.parallel.collectives import average_gradients
from ucnerf_torch.parallel.mvs_views import make_view_sharded_cascade
from ucnerf_torch.parallel.sharding import (parallel_loss, scene_slot,
                                            shard_rays)
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train import __main__ as train_cli
from ucnerf_torch.train.loop import make_eval_render, run_mvs

from bf16_rounding import KERNEL, rounding


class _ReluChoices:
    """``torch.nn.functional`` for ``ucnerf_torch.models.nerf``, whose
    ``relu`` keeps the sign pattern it is given instead of its input's."""

    def __init__(self, masks, rank, n_ranks, record):
        self.masks, self.rank, self.n_ranks = masks, rank, n_ranks
        self.record, self.calls = record, 0

    def __getattr__(self, name):
        return getattr(F, name)

    def relu(self, x):
        if self.record is not None:
            self.record.append((x > 0).numpy())
        if self.masks is None:
            return F.relu(x)
        mask = torch.tensor(self.masks[self.calls % len(self.masks)])
        self.calls += 1
        mask = shard_rays(mask, mask.shape[0], self.n_ranks, self.rank)
        assert mask.shape == x.shape, (mask.shape, x.shape)
        return x * mask.to(x.dtype)


@contextlib.contextmanager
def relu_choices(masks=None, rank=0, n_ranks=1, record=None):
    """Within the block the plain MLP's ReLUs (``models/nerf.py``, in call
    order: the six trunk layers, the two view heads, the blended alpha)
    take the choices ``masks`` (one boolean [N_rays, S, width] array per
    ReLU, over the step's whole ray batch; this rank's slice is the one
    ``shard_rays`` gives it): ``x * mask`` in place of ``relu(x)``, so a
    pre-activation within round-off of 0 passes or stops its gradient as
    the run that made the masks did.  ``record``, a list, collects each
    ReLU's own sign pattern."""
    saved = nerf_module.F
    nerf_module.F = _ReluChoices(masks, rank, n_ranks, record)
    try:
        yield
    finally:
        nerf_module.F = saved


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _loss(mesh, job):
    cfg = parse_config(job["argv"])
    nerf, mvs = create_models(cfg, "cpu", job["params"])
    slot = scene_slot(cfg, mesh)
    batch = to_device_batch(job["samples"][slot], "cpu")
    draws = TrainDraws(*(torch.from_numpy(d) for d in job["draws"][slot]))
    with relu_choices(job.get("relu"), mesh.rank, mesh.size), \
            rounding(nerf, *job.get("rounding", KERNEL)):
        loss, metrics = parallel_loss(cfg, mesh)(nerf, mvs, batch, draws)
        loss.backward()
    params = [p for m in (nerf, mvs) for p in m.parameters()]
    average_gradients(params, mesh.group())
    grads = {f"{name}/{n}": p.grad.numpy()
             for name, m in (("nerf", nerf), ("mvs", mvs))
             for n, p in m.named_parameters()}
    return dict(metrics=_numpy(metrics), grads=grads)


def _cascade(mesh, job):
    """On the first ``job["ranks"]`` ranks (a group of its own when that is
    not all of them; every rank must create it)."""
    n = job["ranks"]
    group = (mesh.group() if n == mesh.size
             else dist.new_group(list(range(n))))
    if mesh.rank >= n:
        return None
    cfg = parse_config(job["argv"])
    _, mvs = create_models(cfg, "cpu", job["params"])
    batch = to_device_batch(job["sample"], "cpu")
    with torch.no_grad():
        return _numpy(run_mvs(cfg, make_view_sharded_cascade(mvs, group),
                              batch))


def _render(mesh, job):
    cfg = parse_config(job["argv"])
    nerf, mvs = create_models(cfg, "cpu", job["params"])
    H, W = job["sample"]["images"].shape[1:3]
    render = make_eval_render(cfg, render_mlp(nerf), mvs, (H, W), mesh=mesh)
    return [t.numpy() for t in render(to_device_batch(job["sample"], "cpu"))]


def _train(mesh, job):
    return [train_cli.main(argv) for argv in job["runs"]]


def _ask(url, body, method):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _http(mesh, job):
    cfg = parse_config(job["argv"])
    renderer, meta = serve.build_renderer(cfg, mesh=mesh)
    if not mesh.is_main:
        time.sleep(job["stall_s"])
        return serve.follow(renderer)
    leader = serve.MeshLeader(renderer)
    srv = serve.make_http_server(leader, meta, port=0,
                                 probe_timeout=job["probe_timeout"])
    th = threading.Thread(target=srv.serve_forever, args=(0.05,),
                          daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    answers = []
    try:
        for method, path, body in job["requests"]:
            t0 = time.perf_counter()
            while True:
                answer = _ask(url + path, body, method.removeprefix("WAIT "))
                if (not method.startswith("WAIT ") or answer[0] == 200
                        or time.perf_counter() - t0 > 30):
                    break
                time.sleep(0.2)
            answers.append((*answer, time.perf_counter() - t0))
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(30)
        leader.shutdown()
    single, _ = serve.build_renderer(cfg, device="cpu")
    frame, _ = serve.encode_frame(*single.render_np(job["c2w"]), "npz")
    return dict(answers=answers, single=frame, renders=leader.n)


KINDS = dict(loss=_loss, cascade=_cascade, render=_render, train=_train,
             http=_http)


def run_jobs(mesh, jobs):
    torch.set_num_threads(1)
    out = [KINDS[job["kind"]](mesh, job) for job in jobs]
    return out if mesh.is_main else None


def hang(mesh):
    while True:
        time.sleep(1.0)
