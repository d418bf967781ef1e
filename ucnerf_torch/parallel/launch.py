"""Self-spawned ranks: one process per rank of a mesh, so that one
command runs a mesh as the JAX package's entry points do.

``run_ranks(target, args, shape, axes, device_type)`` starts
``prod(shape)`` processes with ``torch.multiprocessing``'s spawn method.
The parent holds a ``TCPStore`` on localhost; each rank joins it, inits
the default process group on the backend ``mesh.choose_backend`` picks
(every group with a finite timeout, over the loopback interface),
builds its ``Mesh``, takes the parent's thread count, TF32 switches and
deterministic-kernel settings, and calls
``target(mesh, *args)`` (``target`` is ``"module:function"``).

No rank fails quietly: a rank's exception is sent back with its traceback
and raised in the parent (the same exception, the rank's traceback in its
notes); a rank that dies without one fails the run with its exit code;
the others are killed at once.  With ``timeout`` the parent kills every
rank when it expires and raises TimeoutError.  A SIGINT to the parent is
passed to rank 0 (serve's HTTP mode shuts its ranks down from there),
and the ranks get ``SHUTDOWN_GRACE_S`` to end before they are killed.

``last_stats`` holds each rank's counters of the last run: K1 launches
and peak device memory.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import queue as queue_mod
import signal
import time
import traceback
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ucnerf_torch.parallel.mesh import (check_mesh, choose_backend,
                                        make_mesh, mesh_size, rank_device,
                                        set_current_mesh)

GROUP_TIMEOUT_S = 600.0       # a collective that waits longer raises
SHUTDOWN_GRACE_S = 30.0
POLL_S = 0.05

last_stats: List[dict] = []


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def _settings() -> dict:
    """What a rank takes from its parent: the thread count (shared out
    over the ranks), the TF32 switches and deterministic kernels."""
    return dict(threads=torch.get_num_threads(),
                matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_tf32=torch.backends.cudnn.allow_tf32,
                deterministic=torch.are_deterministic_algorithms_enabled(),
                cudnn_deterministic=torch.backends.cudnn.deterministic)


def _rank_stats(mesh) -> dict:
    from ucnerf_torch.kernels.fused_mlp import fused_nerf_mlp
    peak = (torch.cuda.max_memory_allocated(mesh.device)
            if mesh.device.type == "cuda" else 0)
    return dict(rank=mesh.rank, k1_launches=fused_nerf_mlp.launches,
                peak_mem_bytes=int(peak))


def _rank_main(rank, world, shape, axes, device_type, backend, port,
               settings, target, args, results):
    try:
        torch.set_num_threads(max(1, settings["threads"] // world))
        torch.backends.cuda.matmul.allow_tf32 = settings["matmul_tf32"]
        torch.backends.cudnn.allow_tf32 = settings["cudnn_tf32"]
        # the call costs seconds, and a rank starts with it off
        if settings["deterministic"]:
            torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = settings["cudnn_deterministic"]
        # the ranks talk over the loopback interface only
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        device = rank_device(rank, device_type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
        store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                              timeout=timeout)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=timeout,
            device_id=device if backend == "nccl" else None)
        mesh = make_mesh(shape, axes, rank, device, backend)
        set_current_mesh(mesh)
        out = _resolve(target)(mesh, *args)
        stats = _rank_stats(mesh)
        dist.barrier()
        dist.destroy_process_group()
        results.put(("ok", rank, out, stats))
    except BaseException as e:
        try:
            exc = pickle.loads(pickle.dumps(e))
        except Exception:
            exc = None
        results.put(("error", rank, exc, traceback.format_exc()))
        raise SystemExit(1)


def _kill(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join()


def _raise(rank: int, world: int, exc, tb: str):
    if exc is None:
        raise RuntimeError(f"rank {rank} of {world} failed:\n{tb}")
    exc.add_note(f"raised on rank {rank} of {world}:\n{tb}")
    raise exc


def run_ranks(target: str, args: tuple, shape: Sequence[int],
              axes: Sequence[str], device_type: str,
              timeout: Optional[float] = None) -> list:
    """Run ``target(mesh, *args)`` on every rank of the mesh; returns the
    ranks' results in rank order.  ``last_stats`` gets their counters."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    check_mesh(shape, axes)
    world = mesh_size(shape)
    backend = choose_backend(world, device_type)
    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world, shape, axes, device_type, backend, store.port,
        _settings(), target, args, results)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    done, stats = {}, {}
    interrupted = False
    while len(done) < world:
        try:
            try:
                kind, rank, *payload = results.get(timeout=POLL_S)
            except queue_mod.Empty:
                kind = None
        except KeyboardInterrupt:
            if interrupted:
                _kill(procs)
                raise
            # rank 0 ends the run (serve's HTTP mode shuts every rank
            # down from there); the ranks get a grace period
            interrupted = True
            if procs[0].is_alive():
                os.kill(procs[0].pid, signal.SIGINT)
            deadline = time.monotonic() + SHUTDOWN_GRACE_S
            continue
        if kind == "error":
            _kill(procs)
            _raise(rank, world, *payload)
        if kind == "ok":
            done[rank], stats[rank] = payload
            continue
        dead = [(r, p.exitcode) for r, p in enumerate(procs)
                if r not in done and p.exitcode not in (None, 0)]
        if dead:
            _kill(procs)
            try:        # a rank that raised sent its traceback first
                kind, rank, *payload = results.get(timeout=1.0)
                if kind == "error":
                    _raise(rank, world, *payload)
            except queue_mod.Empty:
                pass
            raise RuntimeError(f"rank {dead[0][0]} of {world} exited with "
                               f"code {dead[0][1]}")
        if deadline is not None and time.monotonic() > deadline:
            _kill(procs)
            limit = SHUTDOWN_GRACE_S if interrupted else timeout
            raise TimeoutError(f"the {world} ranks did not finish within "
                               f"{limit} s; killed them")
    for p in procs:
        p.join(SHUTDOWN_GRACE_S)
    _kill(procs)
    last_stats[:] = [stats[r] for r in range(world)]
    return [done[r] for r in range(world)]
