"""Novel views along a camera trajectory: the port of ``render_path.py``.

    python -m ucnerf_torch.render_path --dataset_name scared \
        --datadir data/scared --view_num 7 --ckpt params.npz \
        --traj interp --n_frames 30 --out frames.npz

The source views are those of the val split's first sample; the
trajectory (``utils/pose_traj.py``: ``spiral``, ``euler``, ``interp``,
``spheric``) runs through its scene's train cameras.  Frames render
through ``ServingRenderer``, so the MLP is the hand-written kernel on the
card.  Frame i+1 is enqueued on the device before frame i is fetched; the
script prints the steady ms per frame.  ``--out x.npz`` writes ``rgb``
[N, H, W, 3] and ``depth`` [N, H, W].  The port has no video encoder, so
any other extension saves ``<out>.npz`` instead and says so, as the JAX
package's script does on a machine without one.  ``--ckpt``, ``--seed``,
``--device`` and ``--mesh_shape`` act as they do for ``python -m
ucnerf_torch.serve``: on a mesh every rank renders its tiles of each
frame and rank 0 writes the npz and prints.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ucnerf_torch.config import parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.parallel import launch
from ucnerf_torch.parallel.mesh import check_mesh, current_mesh, mesh_size
from ucnerf_torch.serve import renderer_for
from ucnerf_torch.utils import pose_traj
from ucnerf_torch.utils.platform import resolve_device


def make_trajectory(name, c2ws, bounds, n_frames):
    if name == "spiral":
        b = bounds if bounds is not None else np.array([0.5, 5.0])
        return pose_traj.render_path_spiral(c2ws, b, n_views=n_frames)
    if name == "euler":
        return pose_traj.gen_render_path_euler(c2ws, n_views=n_frames)
    if name == "interp":
        key_idx = np.linspace(0, len(c2ws) - 1, min(5, len(c2ws))).astype(int)
        return pose_traj.interp_poses_bspline(c2ws, key_idx,
                                              n_views=n_frames)
    if name == "spheric":
        radius = float(np.linalg.norm(c2ws[:, :3, 3], axis=1).mean()) + 1.0
        return pose_traj.create_spheric_poses(radius, n_poses=n_frames)
    raise ValueError(name)


def main(argv=None, timeout=None) -> dict:
    """Render the trajectory.  With more than one rank in
    ``--mesh_shape`` this spawns the ranks and returns rank 0's result;
    ``timeout`` (s) bounds the spawned run."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--traj", default="interp",
                        choices=["spiral", "euler", "interp", "spheric"])
    parser.add_argument("--n_frames", type=int, default=30)
    parser.add_argument("--fps", type=int, default=10,
                        help="kept for the JAX script's flags; no video is "
                        "written")
    parser.add_argument("--out", default="render_path.mp4")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    ns, rest = parser.parse_known_args(argv)
    cfg = parse_config(rest)
    mesh = current_mesh()
    if mesh_size(cfg.mesh_shape) > 1:
        check_mesh(cfg.mesh_shape, cfg.mesh_axes)
        if mesh is None:
            return launch.run_ranks(
                "ucnerf_torch.render_path:_rank_main", (argv,),
                cfg.mesh_shape, cfg.mesh_axes,
                resolve_device(ns.device).type, timeout=timeout)[0]
    dev = resolve_device(ns.device) if mesh is None else mesh.device
    say = print if mesh is None or mesh.is_main else (lambda *a: None)

    ds = build_dataset(cfg, "val")
    W, H = ds.img_wh
    sc = ds.scene[ds.metas[0][0]]
    traj = make_trajectory(ns.traj, sc["c2ws"][sc["train_index"]],
                           sc.get("bounds"), ns.n_frames)
    renderer, _ = renderer_for(cfg, ds, 0, dev, mesh)

    frames, depths, marks = [], [], []
    pending = None
    t0 = time.perf_counter()
    for i, c2w in enumerate(traj):
        rgb, depth, _ = renderer.render(c2w)
        if pending is not None:
            frames.append(pending[0].cpu().numpy())
            depths.append(pending[1].cpu().numpy())
            marks.append(time.perf_counter())
        pending = (rgb, depth)
        say(f"frame {i + 1}/{len(traj)} dispatched")
    frames.append(pending[0].cpu().numpy())
    depths.append(pending[1].cpu().numpy())
    marks.append(time.perf_counter())
    total = marks[-1] - t0
    # the first frame carries the first launches' set-up; the steady
    # frame time is what serving sees
    steady = float(np.median(np.diff(marks[1:]))) if len(marks) > 2 else None
    if steady:
        say(f"rendered {len(frames)} frames in {total:.2f}s (first "
              f"{marks[0] - t0:.2f}s; steady {steady * 1e3:.1f} ms/frame = "
              f"{1.0 / steady:.2f} fps)")
    else:
        say(f"rendered {len(frames)} frames in {total:.2f}s")

    out = ns.out
    if not out.endswith(".npz"):
        out = ns.out + ".npz"
        say(f"ucnerf_torch.render_path: no video writer for {ns.out!r}; "
            f"saved frames to {out} instead")
    if mesh is None or mesh.is_main:
        np.savez(out, rgb=np.stack(frames), depth=np.stack(depths))
    say(f"wrote {out} ({len(frames)} frames, {W}x{H})"
        + ("" if mesh is None else f" on {mesh.size} ranks ({mesh.backend})"))
    return {"out": out, "frames": len(frames), "wall_s": total,
            "steady_ms_per_frame": None if steady is None else steady * 1e3,
            **({} if mesh is None else dict(world_size=mesh.size,
                                            backend=mesh.backend))}


def _rank_main(mesh, argv) -> dict:
    return main(argv)


if __name__ == "__main__":
    main()
