"""serve's HTTP mode on a mesh of CPU ranks (gloo), and the launcher's
time limit."""

import io
import json

import numpy as np
import pytest

from ucnerf_torch.parallel import launch

from test_torch_parallel_cli import FRAME_KEYS, TIMEOUT, _poses
from test_torch_train import ARGS


def test_http_on_a_mesh():
    """HTTP mode on 2 ranks: while the other rank stalls, /health times
    out (503) and /render answers 503 at once instead of waiting on the
    hung probe; once the rank answers, /health probes both ranks and
    names the mesh, a render is the single-device frame bit for bit, a
    malformed request gets 400 without reaching the other rank, and rank
    0 shuts the other down cleanly."""
    c2w = _poses(1)[0]
    body = json.dumps({"c2w": c2w.tolist()}).encode()
    job = dict(kind="http", argv=[*ARGS, "--mesh_shape", "2"], c2w=c2w,
               stall_s=2.5, probe_timeout=0.5,
               requests=[("GET", "/health", None),
                         ("POST", "/render", body),
                         ("WAIT GET", "/health", None),
                         ("POST", "/render", body),
                         ("POST", "/render", b'{"c2w": [[1, 2]]}'),
                         ("GET", "/health", None)])
    out = launch.run_ranks("torch_parallel_worker:run_jobs", ([job],), (2,),
                           ("data",), "cpu", timeout=TIMEOUT)
    res = out[0][0]
    ((h0, timed_out, _), (r0, busy, t_busy), (h1, health, _),
     (r1, frame, _), (r2, bad, _), (h2, _, _)) = res["answers"]
    assert h0 == 503 and "timed out" in json.loads(timed_out)["error"]
    assert r0 == 503 and "hung" in json.loads(busy)["error"]
    assert t_busy < 1.0
    health = json.loads(health)
    assert h1 == h2 == 200 and health["ok"] and health["world_size"] == 2
    assert health["mesh_shape"] == [2] and health["backend"] == "gloo"
    assert r1 == 200 and r2 == 400 and b"4x4" in bad
    got, want = (np.load(io.BytesIO(x)) for x in (frame, res["single"]))
    for k in FRAME_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert res["renders"] == 1 and out[1] is None


def test_launcher_kills_ranks_past_their_time_limit():
    """Ranks that never return: the caller gets TimeoutError once the
    limit passes, and the ranks are killed and joined."""
    with pytest.raises(TimeoutError, match="killed"):
        launch.run_ranks("torch_parallel_worker:hang", (), (2,), ("data",),
                         "cpu", timeout=2)
