"""``python -m ucnerf_torch.serve``'s HTTP and batch modes on the CPU, the
six cases of ``tests/test_serve.py`` held against the port: the round trip
(npz bit for bit equal to ``render_np``, png decoded by PIL), the batch
CLI with a ``.png`` out, request failure modes, health with a wedged
device, serialized concurrent requests and malformed batch lines.  Then
``ucnerf_torch.utils.pose_traj`` against the JAX package's trajectories,
and ``python -m ucnerf_torch.render_path`` against ``render_np`` of each
of its poses."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from ucnerf_tpu.utils import pose_traj as j_pose_traj

from ucnerf_torch import render_path, serve
from ucnerf_torch.config import parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.utils import pose_traj
from ucnerf_torch.utils.png import decode_png

torch.set_num_threads(1)

ARGS = ["--dataset_name", "synthetic", "--img_wh", "64", "32", "--view_num",
        "4", "--N_samples", "9", "--ndepths", "8", "8", "8", "--chunk", "256"]
TIMEOUT = 120


@pytest.fixture(scope="module")
def served():
    """One renderer, and its frame of the scene's own pose."""
    renderer, meta = serve.build_renderer(parse_config(ARGS), device="cpu")
    c2w = np.asarray(meta["example_c2w"], np.float32)
    return renderer, meta, renderer.render_np(c2w)


@pytest.fixture
def server(served):
    """A live server on a free port over the shared renderer."""
    renderer, meta, _ = served
    srv = serve.make_http_server(renderer, meta, port=0)
    th = threading.Thread(target=srv.serve_forever, args=(0.05,),
                          daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    th.join(TIMEOUT)
    assert not th.is_alive()


def _post(url, body: bytes):
    return urllib.request.urlopen(urllib.request.Request(
        url + "/render", data=body), timeout=TIMEOUT)


def _http_error(fn) -> urllib.error.HTTPError:
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value


def test_http_render_roundtrip(served, server):
    """GET /health, then POST /render as npz (bit for bit the direct
    render) and as png (PIL and ``decode_png`` read the 8-bit frame); a
    malformed request gets 400 and the server lives on."""
    _, _, (rgb, depth, conf) = served
    with urllib.request.urlopen(server + "/health", timeout=TIMEOUT) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["probe_ms"] >= 0
    assert health["img_wh"] == [64, 32] and health["mesh_shape"] == [1]
    c2w = health["example_c2w"]
    with _post(server, json.dumps({"c2w": c2w}).encode()) as r:
        data = np.load(io.BytesIO(r.read()))
    np.testing.assert_array_equal(data["rgb"], rgb)
    np.testing.assert_array_equal(data["depth"], depth)
    np.testing.assert_array_equal(data["confidence"], conf)
    with _post(server, json.dumps({"c2w": c2w, "format": "png"}).encode()
               ) as r:
        assert r.headers["Content-Type"] == "image/png"
        png = r.read()
    want = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  want)
    np.testing.assert_array_equal(decode_png(png), want)
    for body, msg in ((b'{"c2w": [[1, 2], [3, 4]]}', "4x4"),
                      (b"{not json", "Expecting"),
                      (b"[1, 2]", "JSON object")):
        err = _http_error(lambda: _post(server, body))
        assert err.code == 400 and msg in json.loads(err.read())["error"]
    err = _http_error(lambda: urllib.request.urlopen(server + "/nowhere",
                                                     timeout=TIMEOUT))
    assert err.code == 404


def test_batch_mode_cli(served, tmp_path, capsys):
    """--requests renders each line to its out path, pipelined; a .png
    out gets the 8-bit frame; exactly one of --port / --requests."""
    _, meta, (rgb, depth, conf) = served
    reqs = tmp_path / "reqs.jsonl"
    outs = [str(tmp_path / "f0.npz"), str(tmp_path / "f1.png")]
    reqs.write_text("".join(json.dumps({"c2w": meta["example_c2w"],
                                        "out": o}) + "\n" for o in outs))
    assert serve.main(["--requests", str(reqs), "--device", "cpu",
                       *ARGS]) == 2
    assert json.loads(capsys.readouterr().out.splitlines()[-2])["frames"] == 2
    data = np.load(outs[0])
    np.testing.assert_array_equal(data["rgb"], rgb)
    np.testing.assert_array_equal(data["depth"], depth)
    np.testing.assert_array_equal(data["confidence"], conf)
    np.testing.assert_array_equal(np.asarray(Image.open(outs[1])),
                                  (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    for argv in ([], ["--requests", str(reqs), "--port", "0"]):
        with pytest.raises(SystemExit):
            serve.main([*argv, "--device", "cpu", *ARGS])


def test_validate_request_failure_modes():
    ok = np.eye(4).tolist()
    for bad in [{}, {"c2w": None}, {"c2w": "not a matrix"},
                {"c2w": [[1, 2], [3, 4]]}, {"c2w": [[1] * 4] * 3},
                {"c2w": [[[1] * 4] * 4]},
                {"c2w": (np.eye(4) * np.nan).tolist()},
                {"c2w": ok, "format": "jpeg"}, [1, 2], "c2w"]:
        with pytest.raises((ValueError, TypeError)):
            serve.validate_request(bad)
    for fmt in ("npz", "png"):
        c2w, got = serve.validate_request({"c2w": ok, "format": fmt})
        assert c2w.shape == (4, 4) and got == fmt
    assert serve.validate_request({"c2w": ok})[1] == "npz"


def test_health_probe_reports_wedged_device(served, server, monkeypatch):
    """With the device round trip hung, the probe times out; later probes
    fail at once while it stays hung, and report healthy once it ends.
    Over HTTP: 503, then 200 again."""
    assert serve.probe_backend(TIMEOUT)["ok"]
    release = threading.Event()
    monkeypatch.setattr(serve, "device_round_trip",
                        lambda device: release.wait(TIMEOUT))
    res = serve.probe_backend(0.2)
    assert not res["ok"] and "timed out" in res["error"]
    t0 = time.perf_counter()
    res = serve.probe_backend(TIMEOUT)
    assert not res["ok"] and "hung" in res["error"]
    assert time.perf_counter() - t0 < 1.0
    err = _http_error(lambda: urllib.request.urlopen(server + "/health",
                                                     timeout=TIMEOUT))
    assert err.code == 503 and "hung" in json.loads(err.read())["error"]
    release.set()
    hung = serve._PROBE_HUNG[0]
    hung.join(TIMEOUT)
    assert not hung.is_alive()
    monkeypatch.undo()
    with urllib.request.urlopen(server + "/health", timeout=TIMEOUT) as r:
        assert json.loads(r.read())["ok"]
    assert serve._PROBE_HUNG[0] is None


def test_concurrent_requests_serialize(served, server):
    """Four concurrent clients all get the exact frame, and the renderer
    never runs two renders at once."""
    renderer, meta, (rgb, _, _) = served
    in_flight, peak = [0], [0]
    lock = threading.Lock()
    real = renderer.render_np

    def counting(c2w):
        with lock:
            in_flight[0] += 1
            peak[0] = max(peak[0], in_flight[0])
        try:
            return real(c2w)
        finally:
            with lock:
                in_flight[0] -= 1
    renderer.render_np = counting
    body = json.dumps({"c2w": meta["example_c2w"]}).encode()
    results = [None] * 4

    def client(i):
        with _post(server, body) as r:
            results[i] = r.read()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(TIMEOUT)
            assert not th.is_alive()
    finally:
        del renderer.render_np
    for r in results:
        np.testing.assert_array_equal(np.load(io.BytesIO(r))["rgb"], rgb)
    assert peak[0] == 1, f"renders interleaved (peak {peak[0]})"


def test_batch_mode_survives_malformed_lines(served, tmp_path, capsys):
    renderer, meta, (rgb, _, _) = served
    out_ok = str(tmp_path / "good.npz")
    n = serve.run_batch(renderer, [
        "{not json",
        json.dumps({"c2w": meta["example_c2w"]}),                # no out
        json.dumps({"c2w": [[1, 2]], "out": str(tmp_path / "x.npz")}),
        "[1, 2]",
        json.dumps({"c2w": meta["example_c2w"], "out": out_ok})])
    assert n == 1
    outs = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    errors = [o["error"] for o in outs if "error" in o]
    assert len(errors) == 4
    assert any("out" in e for e in errors) and any("4x4" in e for e in errors)
    np.testing.assert_array_equal(np.load(out_ok)["rgb"], rgb)


def _scene():
    ds = build_dataset(parse_config(ARGS), "val")
    sc = ds.scene[ds.metas[0][0]]
    return sc["c2ws"][sc["train_index"]]


@pytest.mark.parametrize("traj", ["spiral", "euler", "interp", "spheric"])
def test_trajectories_match_jax(traj):
    c2ws = _scene()
    got = render_path.make_trajectory(traj, c2ws, None, 7)
    key_idx = np.linspace(0, len(c2ws) - 1, 3).astype(int)
    want = {
        "spiral": lambda: j_pose_traj.render_path_spiral(
            c2ws, np.array([0.5, 5.0]), n_views=7),
        "euler": lambda: j_pose_traj.gen_render_path_euler(c2ws, n_views=7),
        "interp": lambda: j_pose_traj.interp_poses_bspline(
            c2ws, np.linspace(0, len(c2ws) - 1, min(5, len(c2ws)))
            .astype(int), n_views=7),
        "spheric": lambda: j_pose_traj.create_spheric_poses(
            float(np.linalg.norm(c2ws[:, :3, 3], axis=1).mean()) + 1.0,
            n_poses=7)}[traj]()
    assert got.shape[1:] == (4, 4) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    if traj == "interp":         # the slerp variant the bspline path skips
        np.testing.assert_array_equal(
            pose_traj.interp_poses_slerp(c2ws, key_idx, 5),
            j_pose_traj.interp_poses_slerp(c2ws, key_idx, 5))


def test_render_path_cli(served, tmp_path, capsys):
    """Three interp frames to npz, each equal to ``render_np`` of its pose;
    a video extension falls back to ``<out>.npz``."""
    renderer, _, _ = served
    out = str(tmp_path / "path.mp4")
    res = render_path.main(["--n_frames", "3", "--out", out, "--device",
                            "cpu", *ARGS])
    assert res["out"] == out + ".npz" and res["frames"] == 3
    assert "no video writer" in capsys.readouterr().out
    data = np.load(out + ".npz")
    assert data["rgb"].shape == (3, 32, 64, 3)
    for i, c2w in enumerate(render_path.make_trajectory("interp", _scene(),
                                                        None, 3)):
        rgb, depth, _ = renderer.render_np(c2w)
        np.testing.assert_array_equal(data["rgb"][i], rgb)
        np.testing.assert_array_equal(data["depth"][i], depth)


def test_entry_points_default_to_the_card():
    """Without a card and without an explicit CPU request the entry point
    raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cpu"):
        serve.build_renderer(parse_config(ARGS))
