"""Pose -> frame render server of the port.

Holds one scene's source views, weights and cached FeatureNet features on
the device (``render/serving.py``) and renders novel views on demand; on
the card the NeRF MLP runs as the hand-written kernel
(``kernels/fused_mlp.py``).

HTTP mode:

    python -m ucnerf_torch.serve --dataset_name scared --datadir data/scared \
        --view_num 7 --ckpt logs/scared/ckpts/step_00005000 --port 8080
    curl -s localhost:8080/health
    curl -s -X POST --data-binary @req.json localhost:8080/render > f.npz
    # req.json: {"c2w": [[...4x4...]], "format": "npz" | "png"}

``GET /health`` answers 200 with the scene's metadata and a timed device
round trip (``probe_ms``), or 503 when the device does not answer within
``--probe_timeout`` seconds.  ``POST /render`` answers the frame, or 400
for a malformed request.  One listener thread takes one request at a
time, and the render itself holds a lock: concurrent clients queue.

Batch mode:

    python -m ucnerf_torch.serve ... --requests reqs.jsonl
    # each line: {"c2w": [[...4x4...]], "out": "frame_001.npz"}

Output lines are JSON: one ``{"out", "ms"}`` per frame, ``{"error",
"line"}`` for a malformed request (the batch goes on), and a final
``{"frames", "wall_ms", "ms_per_frame"}``.  Exactly one of ``--port`` and
``--requests`` is given.

Frames are ``npz`` (rgb f32, depth f32, confidence f32) or ``png`` (rgb as
8-bit RGB, ``utils/png.py``); a batch line whose ``out`` ends in ``.png``
asks for png.  ``--ckpt`` takes every form ``python -m ucnerf_torch.train``
reads; without it the weights are drawn from ``--seed``.  ``--device cpu``
runs on the CPU; the default is the card.

Multi-rank (``--mesh_shape`` with more than one rank, any
``--mesh_axes``): the entry point spawns one process per rank
(``parallel/launch.py``) and every frame's pixel tiles split over all of
them.  In batch mode every rank walks the same requests and rank 0
writes the frames and prints.  In HTTP mode rank 0 listens; it
broadcasts each valid request's pose to the other ranks, which loop on
the broadcasts until rank 0 sends a shutdown (a SIGINT to the command
ends the server so), and which also take part in the health probe (a
device round trip and an all-reduce on every rank).  When idle, rank 0
broadcasts a heartbeat every ``HEARTBEAT_S`` so the waiting ranks stay
inside their collectives' timeout.  While a probe is hung (a rank that
does not answer), ``/render`` answers 503 at once instead of waiting on
the mesh; so does a render that waits ``LOCK_WAIT_S`` for the mesh's
lock.  The metadata's ``mesh_shape``,
``world_size`` and ``backend`` name the mesh in use.
"""

from __future__ import annotations

import argparse
import io
import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import torch
import torch.distributed as dist

from ucnerf_torch.config import parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.kernels.fused_mlp import render_mlp
from ucnerf_torch.models.factory import create_models
from ucnerf_torch.parallel import launch
from ucnerf_torch.parallel.collectives import broadcast_
from ucnerf_torch.parallel.mesh import check_mesh, current_mesh, mesh_size
from ucnerf_torch.render.serving import ServingRenderer
from ucnerf_torch.utils.checkpoint_io import load_params
from ucnerf_torch.utils.platform import resolve_device
from ucnerf_torch.utils.png import encode_png

HEARTBEAT_S = 60.0
LOCK_WAIT_S = 10.0
# what rank 0 broadcasts to the other ranks in HTTP mode: [op, c2w (16)]
OP_RENDER, OP_PROBE, OP_HEARTBEAT, OP_SHUTDOWN = range(4)


def renderer_for(cfg, ds, scene_idx: int, dev, mesh=None) -> tuple:
    """(ServingRenderer, metadata) of sample ``scene_idx`` of ``ds`` on
    ``dev``, with the weights of ``--seed`` / ``--ckpt``; its frames split
    over ``mesh``'s ranks when given."""
    W, H = ds.img_wh
    nerf, mvs = create_models(cfg, dev, load_params(cfg, dev))
    sample = ds[scene_idx]
    scan = ds.metas[scene_idx][0]
    renderer = ServingRenderer(cfg, render_mlp(nerf), mvs, sample, (H, W),
                               ds.scene[scan]["intrinsic"], dev, mesh)
    meta = {"scan": str(scan), "img_wh": [W, H], "view_num": cfg.view_num,
            "N_samples": cfg.N_samples, "chunk": cfg.chunk,
            "mesh_shape": [1] if mesh is None else list(mesh.shape),
            "world_size": 1 if mesh is None else mesh.size,
            "backend": None if mesh is None else mesh.backend,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "example_c2w": np.asarray(sample["c2ws"][0]).tolist()}
    return renderer, meta


def build_renderer(cfg, scene_idx: int = 0, device=None, mesh=None):
    """Dataset + models + weights -> (ServingRenderer, metadata); on the
    rank's device of ``mesh`` when given."""
    dev = resolve_device(device) if mesh is None else mesh.device
    return renderer_for(cfg, build_dataset(cfg, "val"), scene_idx, dev,
                        mesh)


def encode_frame(rgb, depth, conf, fmt: str) -> tuple:
    """(payload bytes, content-type) for a rendered frame."""
    if fmt == "png":
        return (encode_png((np.clip(rgb, 0, 1) * 255).astype(np.uint8)),
                "image/png")
    buf = io.BytesIO()
    np.savez(buf, rgb=rgb, depth=depth, confidence=conf)
    return buf.getvalue(), "application/octet-stream"


def validate_request(req: dict) -> tuple:
    """Request dict -> (c2w [4,4] f32, fmt).  Raises ValueError or
    TypeError on a malformed request (HTTP maps them to 400)."""
    if not isinstance(req, dict):
        raise ValueError(f"a request is a JSON object, got "
                         f"{type(req).__name__}")
    c2w = np.asarray(req.get("c2w", None), dtype=np.float32)
    if c2w.shape != (4, 4):
        raise ValueError(f"'c2w' must be a 4x4 matrix, got {c2w.shape}")
    if not np.isfinite(c2w).all():
        raise ValueError("'c2w' contains non-finite values")
    fmt = req.get("format", "npz")
    if fmt not in ("npz", "png"):
        raise ValueError(f"unknown format {fmt!r} (npz|png)")
    return c2w, fmt


def handle_render(renderer: ServingRenderer, req: dict) -> tuple:
    """Validate one request dict and render it -> (payload, content_type)."""
    c2w, fmt = validate_request(req)
    return encode_frame(*renderer.render_np(c2w), fmt)


def device_round_trip(device) -> float:
    """A tiny tensor to ``device`` and back; returns the value."""
    return float(torch.full((), 2.0, device=device).cpu())


# the last probe thread that timed out, None while the device answers: a
# hung device is the whole process's, so every server shares the latch
_PROBE_HUNG = [None]


class DeviceBusy(RuntimeError):
    """The device (or a rank of the mesh) does not answer: the request
    gets 503."""


def probe_hung() -> bool:
    """Whether a timed-out probe is still waiting on the device."""
    return _PROBE_HUNG[0] is not None and _PROBE_HUNG[0].is_alive()


def probe_backend(timeout_s: float = 10.0, device="cpu",
                  round_trip=None) -> dict:
    """``device_round_trip`` (or ``round_trip()``, the mesh's probe) on a
    daemon thread, joined for at most ``timeout_s``: a hung device
    reports unhealthy instead of hanging the health check.  While a
    timed-out probe is still alive, later probes fail at once instead of
    stacking more hung threads; once it finishes (a slow round trip, not
    a hang) the device reports healthy again."""
    if probe_hung():
        return {"ok": False, "error":
                "previous device probe still hung; device wedged"}
    _PROBE_HUNG[0] = None
    result = {}

    def work():
        try:
            t0 = time.perf_counter()
            result["value"] = (device_round_trip(device) if round_trip
                               is None else round_trip())
            result["ms"] = (time.perf_counter() - t0) * 1e3
        except Exception as e:        # reported as unhealthy, not a crash
            result["error"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=work, daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        _PROBE_HUNG[0] = th
        return {"ok": False,
                "error": f"device probe timed out after {timeout_s}s"}
    if "error" in result:
        return {"ok": False, "error": result["error"]}
    return {"ok": True, "probe_ms": round(result["ms"], 3)}


class MeshLeader:
    """Rank 0's side of HTTP mode on a mesh: ``render`` / ``render_np``
    broadcast the pose before rendering, ``round_trip`` runs the probe on
    every rank, ``heartbeat`` keeps the idle ranks inside their
    collectives' timeout, ``shutdown`` ends their loop (``follow``).  A
    render or probe that waits ``LOCK_WAIT_S`` for the lock (held by a
    probe that a rank left hanging) raises ``DeviceBusy``."""

    def __init__(self, renderer: ServingRenderer):
        self.renderer = renderer
        self.mesh = renderer.mesh
        self.device = renderer.device
        self.sample = renderer.sample
        self.lock = threading.Lock()
        self.last = time.monotonic()
        self.n = 0

    def _send(self, op: int, c2w=None):
        msg = torch.zeros(17, dtype=torch.float32, device=self.device)
        msg[0] = op
        if c2w is not None:
            msg[1:] = torch.as_tensor(np.asarray(c2w, np.float32).ravel())
        broadcast_(msg, self.mesh.group())
        self.last = time.monotonic()

    def _acquire(self):
        if not self.lock.acquire(timeout=LOCK_WAIT_S):
            raise DeviceBusy(f"the mesh is still busy after {LOCK_WAIT_S}s;"
                             " a rank does not answer")

    def render(self, c2w):
        self._acquire()
        try:
            self._send(OP_RENDER, c2w)
            self.n += 1
            return self.renderer.render(c2w)
        finally:
            self.lock.release()

    def render_np(self, c2w):
        return tuple(t.cpu().numpy() for t in self.render(c2w))

    def round_trip(self) -> float:
        self._acquire()
        try:
            self._send(OP_PROBE)
            return mesh_round_trip(self.mesh)
        finally:
            self.lock.release()

    def heartbeat(self):
        if (time.monotonic() - self.last > HEARTBEAT_S
                and self.lock.acquire(blocking=False)):
            try:
                self._send(OP_HEARTBEAT)
            finally:
                self.lock.release()

    def shutdown(self):
        with self.lock:
            self._send(OP_SHUTDOWN)


def mesh_round_trip(mesh) -> float:
    """``device_round_trip`` on every rank, then an all-reduce that counts
    the ranks whose round trip gave its value back; raises unless all
    did."""
    value = device_round_trip(mesh.device)
    answered = torch.full((), float(value == 2.0), device=mesh.device)
    dist.all_reduce(answered, group=mesh.group())
    if float(answered.cpu()) != mesh.size:
        raise RuntimeError(f"{float(answered.cpu()):.0f} of {mesh.size} "
                           f"ranks answered the probe")
    return value


def follow(renderer: ServingRenderer):
    """The loop of ranks other than 0 in HTTP mode: render each pose rank
    0 broadcasts, answer its probes, return at its shutdown.  SIGINT is
    rank 0's to act on."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    mesh = renderer.mesh
    msg = torch.zeros(17, dtype=torch.float32, device=renderer.device)
    n = 0
    while True:
        broadcast_(msg, mesh.group())
        op = int(msg[0])
        if op == OP_RENDER:
            renderer.render(msg[1:].reshape(4, 4).cpu().numpy())
            n += 1
        elif op == OP_PROBE:
            mesh_round_trip(mesh)
        elif op == OP_SHUTDOWN:
            return n


def make_http_server(renderer, meta, host: str = "127.0.0.1",
                     port: int = 8080, probe_timeout: float = 10.0):
    """A single-threaded HTTP server on (host, port); port 0 takes a free
    one.  The caller runs ``.serve_forever()``.  ``renderer`` may be a
    ``MeshLeader``: the probe then runs on every rank, and the server's
    idle loop sends its heartbeat."""
    render_lock = threading.Lock()
    round_trip = getattr(renderer, "round_trip", None)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path.split("?")[0] == "/health":
                probe = probe_backend(probe_timeout, renderer.device,
                                      round_trip)
                self._send(200 if probe["ok"] else 503,
                           json.dumps({**meta, **probe}).encode(),
                           "application/json")
            else:
                self._send(404, b'{"error": "use GET /health or POST '
                                b'/render"}', "application/json")

        def do_POST(self):
            if self.path != "/render":
                self._send(404, b'{"error": "POST /render"}',
                           "application/json")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if probe_hung():
                    raise DeviceBusy("a device probe is still hung; device "
                                     "wedged")
                t0 = time.perf_counter()
                with render_lock:
                    payload, ctype = handle_render(renderer, req)
                self.log_message("rendered in %.1f ms",
                                 (time.perf_counter() - t0) * 1e3)
                self._send(200, payload, ctype)
            except (ValueError, TypeError) as e:   # JSONDecodeError too
                self._send(400, json.dumps({"error": str(e)}).encode(),
                           "application/json")
            except DeviceBusy as e:
                self._send(503, json.dumps({"error": str(e)}).encode(),
                           "application/json")

        def log_message(self, fmt, *args):
            sys.stderr.write("ucnerf_torch.serve: " + fmt % args + "\n")

    srv = HTTPServer((host, port), Handler)
    if isinstance(renderer, MeshLeader):
        srv.service_actions = renderer.heartbeat
    return srv


def run_batch(renderer, lines, pipeline: bool = True,
              write: bool = True) -> int:
    """JSON-lines mode: render each request to its 'out' path.

    With ``pipeline`` (file input) frame i+1 is enqueued on the device
    before frame i is fetched, so the fetch and file write of frame i
    overlap the device work of frame i+1.  Without ``write`` (the ranks
    other than 0 of a mesh) the frames are rendered and neither written
    nor printed."""
    n = 0
    pending = None  # ((rgb, depth, conf) device tensors, out path, fmt, t0)
    say = print if write else (lambda *a: None)

    def flush(item):
        frame, out, fmt, t0 = item
        if not write:
            return
        payload, _ = encode_frame(*(t.cpu().numpy() for t in frame), fmt)
        with open(out, "wb") as fh:
            fh.write(payload)
        print(json.dumps({"out": out,
                          "ms": round((time.perf_counter() - t0) * 1e3, 1)}))

    t_all = time.perf_counter()
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if not isinstance(req, dict) or "out" not in req:
                raise ValueError("request missing 'out' path")
            out = req["out"]
            fmt = req.get("format",
                          "png" if str(out).endswith(".png") else "npz")
            c2w, fmt = validate_request(dict(req, format=fmt))
        except (ValueError, TypeError) as e:
            # a malformed line must not kill the remaining batch
            say(json.dumps({"error": str(e), "line": line[:200]}))
            continue
        t0 = time.perf_counter()
        frame = renderer.render(c2w)
        if pending is not None:
            flush(pending)
        pending = (frame, out, fmt, t0)
        if not pipeline:
            flush(pending)
            pending = None
        n += 1
    if pending is not None:
        flush(pending)
    if n:
        wall = time.perf_counter() - t_all
        say(json.dumps({"frames": n, "wall_ms": round(wall * 1e3, 1),
                        "ms_per_frame": round(wall * 1e3 / n, 1)}))
    return n


def main(argv=None, timeout=None):
    """Serve in batch or HTTP mode.  With more than one rank in
    ``--mesh_shape`` this spawns the ranks (batch requests from stdin are
    read here first and handed to every rank) and returns rank 0's
    result; ``timeout`` (s) bounds the spawned run."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--port", type=int, default=None,
                        help="HTTP mode: listen on this port (0: any free)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--requests", default=None,
                        help="batch mode: JSON-lines request file, '-' = "
                        "stdin")
    parser.add_argument("--probe_timeout", type=float, default=10.0,
                        help="GET /health device probe timeout (s)")
    parser.add_argument("--scene_idx", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    ns, rest = parser.parse_known_args(argv)
    if (ns.port is None) == (ns.requests is None):
        parser.error("exactly one of --port / --requests is required")
    cfg = parse_config(rest)
    mesh = current_mesh()
    if mesh_size(cfg.mesh_shape) > 1:
        check_mesh(cfg.mesh_shape, cfg.mesh_axes)
        if mesh is None:
            stdin = (sys.stdin.readlines() if ns.requests == "-" else None)
            return launch.run_ranks(
                "ucnerf_torch.serve:_rank_main", (argv, stdin),
                cfg.mesh_shape, cfg.mesh_axes,
                resolve_device(ns.device).type, timeout=timeout)[0]
    return serve(cfg, ns, mesh)


def _rank_main(mesh, argv, stdin=None):
    if stdin is not None:
        sys.stdin = io.StringIO("".join(stdin))
    return main(argv)


def serve(cfg, ns, mesh=None):
    """The parsed run: batch mode returns the count of frames rendered;
    HTTP mode serves until interrupted (on a mesh a SIGINT then shuts
    every rank down, and each returns the count of requests it
    rendered)."""
    main_rank = mesh is None or mesh.is_main
    renderer, meta = build_renderer(cfg, ns.scene_idx, ns.device, mesh)
    t0 = time.perf_counter()
    renderer.render_np(np.asarray(renderer.sample["c2ws"][0]))
    if main_rank:
        print(f"ucnerf_torch.serve: warmed up in "
              f"{time.perf_counter() - t0:.1f}s; scene {meta['scan']} at "
              f"{meta['img_wh']} on {meta['device']}"
              + ("" if mesh is None else f" x {mesh.size} ranks "
                 f"({mesh.backend})"), flush=True)
    if ns.requests is not None:
        if ns.requests == "-":
            n = run_batch(renderer, sys.stdin, pipeline=False,
                          write=main_rank)
        else:
            with open(ns.requests) as fh:
                n = run_batch(renderer, fh, write=main_rank)
        if main_rank:
            print(f"ucnerf_torch.serve: rendered {n} request(s)")
        return n
    if not main_rank:
        return follow(renderer)

    leader = renderer if mesh is None else MeshLeader(renderer)
    srv = make_http_server(leader, meta, ns.host, ns.port,
                           probe_timeout=ns.probe_timeout)
    print(f"ucnerf_torch.serve: listening on http://{srv.server_address[0]}:"
          f"{srv.server_address[1]} (GET /health, POST /render)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        if mesh is None:
            raise
    finally:
        srv.server_close()
    if mesh is None:
        return 0
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    leader.shutdown()
    print(f"ucnerf_torch.serve: rendered {leader.n} request(s); shut down "
          f"{mesh.size} ranks", flush=True)
    return leader.n


if __name__ == "__main__":
    main()
