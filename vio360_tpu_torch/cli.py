"""Command-line VO / VIO runner (the port's main path).

Counterpart of ``vio360_tpu/cli.py`` for the ported slices::

    python -m vio360_tpu_torch DATASET [--no-loop] [--no-pose-graph] \\
        [--lk-backend matmul] [--vo] [--config cfg.yaml] [--output traj.tum] \\
        [--metrics m.jsonl] [--device cuda:0|cpu]

A dataset with IMU rows runs VIO unless ``--vo`` is given. Loop closure
and the pose graph are on, as in ``VioConfig()``; ``--no-loop`` /
``--no-pose-graph`` turn them off (the YAML loader reads no keys for
them). ``--device`` defaults to the card; without one the run stops with
an error unless ``--device cpu`` is given. Anything that needs a part of
the system not ported yet exits with code 2 and names it: the flags
``--mesh``, ``--frames-per-dispatch`` > 1, ``--checkpoint``,
``--resume``, ``--step``, ``--x64``, ``--profile`` and ``--viz-dir``.
The frame loop
is always sequential, so ``--no-pipelined`` is accepted and changes
nothing; the megastep / pipelined settings are host-loop strategies the
JAX package proves equal to the sequential loop (tests/test_megastep.py,
tests/test_pipelined.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

_REFUSED_FLAGS = {
    "mesh": "the distributed window solve (--mesh)",
    "checkpoint": "checkpoints (--checkpoint)",
    "resume": "checkpoint resume (--resume)",
    "step": "interactive stepping (--step)",
    "pause_on_init": "interactive stepping (--pause-on-init)",
    "x64": "double precision (--x64)",
    "profile": "the profiler trace (--profile)",
    "viz_dir": "visualization output (--viz-dir)",
}


def _refuse(what: str) -> int:
    print(f"error: not ported yet: {what}", file=sys.stderr)
    return 2


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="vio360_tpu_torch",
                                description="360 VO / VIO on PyTorch + CUDA")
    p.add_argument("dataset_dir", help="dataset directory (images/ + cam_timestamps.txt)")
    p.add_argument("--config", default=None, help="reference-format YAML config")
    p.add_argument("--output", default="trajectory.tum", help="TUM trajectory output path")
    p.add_argument("--metrics", default=None, help="JSONL per-frame metrics path")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--vo", action="store_true", help="visual-only: ignore the IMU stream")
    p.add_argument("--no-loop", action="store_true", help="turn loop closure off")
    p.add_argument("--no-pose-graph", action="store_true", help="turn the pose graph off")
    p.add_argument("--no-pipelined", action="store_true", help="accepted; the loop is sequential")
    p.add_argument("--image-transport", default=None, choices=["f32", "u8", "u16"])
    p.add_argument("--lk-backend", default=None, choices=["auto", "xla", "matmul", "pallas"],
                   help="LK front end: matmul = the matmul-gather LK, else the per-feature LK")
    p.add_argument("--device", default=None, help="torch device (default: cuda:0)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--frames-per-dispatch", type=int, default=None, metavar="K")
    p.add_argument("--mesh", default=None, metavar="AXIS=N")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--step", action="store_true")
    p.add_argument("--pause-on-init", action="store_true")
    p.add_argument("--x64", action="store_true")
    p.add_argument("--profile", default=None, metavar="DIR")
    p.add_argument("--viz-dir", default=None)
    args = p.parse_args(argv)

    for flag, what in _REFUSED_FLAGS.items():
        if getattr(args, flag):
            return _refuse(what)
    if args.frames_per_dispatch and args.frames_per_dispatch > 1:
        return _refuse("batched dispatch (--frames-per-dispatch > 1)")
    if not os.path.isdir(args.dataset_dir):
        print(f"error: dataset directory not found: {args.dataset_dir}", file=sys.stderr)
        return 2
    ts_file = os.path.join(args.dataset_dir, "cam_timestamps.txt")
    if not os.path.isfile(ts_file):
        print(f"error: missing {ts_file}", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(args.dataset_dir, "images")):
        print("error: missing images directory", file=sys.stderr)
        return 2

    from . import config as cfgmod
    from . import device as device_mod
    from .estimator.estimator import Estimator, unported_features
    from .io import dataset as ds
    from .io import trajectory as tio
    from .utils.logging import MetricsWriter, get_logger

    device_mod.pin_fp32()
    log = get_logger("vio360.torch.cli")
    if args.config:
        if not os.path.isfile(args.config):
            print(f"error: config not found: {args.config}", file=sys.stderr)
            return 2
        cfg = cfgmod.load_yaml(args.config)
    else:
        cfg = cfgmod.VioConfig()
    if args.no_loop:
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enabled=False))
    if args.no_pose_graph:
        cfg = dataclasses.replace(cfg, pose_graph=dataclasses.replace(cfg.pose_graph, enabled=False))
    if args.lk_backend:
        cfg = dataclasses.replace(cfg, optical_flow=dataclasses.replace(
            cfg.optical_flow, backend=args.lk_backend))
    if args.image_transport:
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, image_transport=args.image_transport))
    missing = unported_features(cfg)
    if missing:
        return _refuse(", ".join(missing))

    # The Python decode path (numpy / PIL): the optional native prefetch
    # decoder (io/native_loader.py) is not part of this slice.
    data = ds.VioDataset(args.dataset_dir, image_size=(cfg.camera.width, cfg.camera.height))
    n = len(data)
    if n == 0:
        print("error: dataset contains no frames", file=sys.stderr)
        return 2
    if args.max_frames:
        n = min(n, args.max_frames)

    try:
        device = device_mod.resolve(args.device)
    except RuntimeError as e:  # no card and no --device
        print(f"error: {e}", file=sys.stderr)
        return 2
    est = Estimator(cfg, device=device)
    log.info("dataset: %d frames, %d IMU samples on %s", n, data.imu.shape[0], est.device)
    metrics = MetricsWriter(args.metrics)
    t0 = time.time()
    n_kf = 0
    for frame in data:
        if frame.index >= n:
            break
        res = est.process_frame(frame.image, frame.timestamp, None if args.vo else frame.imu)
        n_kf += int(res.is_keyframe)
        metrics.write(frame=res.frame_id, t=res.timestamp, state=res.state,
                      keyframe=res.is_keyframe, tracked=res.n_tracked, inliers=res.n_pnp_inliers,
                      **{k: v for k, v in res.diag.items() if np.isscalar(v)})
        if not args.quiet and (res.frame_id % 10 == 0 or res.is_keyframe):
            log.info("frame %4d  %-13s tracked=%4d inliers=%4d%s", res.frame_id, res.state,
                     res.n_tracked, res.n_pnp_inliers, "  [KF]" if res.is_keyframe else "")
    wall = time.time() - t0
    ts, rs, ps = est.export_trajectory()  # runs the pose-graph solve
    n_loop = sum(e.kind == "loop" for e in est.pg_edges)
    vis_w = [float(e.w_sqrt[0]) for e in est.pg_edges if e.kind == "vis"]
    metrics.write(event="pose_graph", nodes=len(est.pg_nodes), edges=len(est.pg_edges),
                  loop_edges=n_loop, sim3_nodes=len(est.kf_scale_log),
                  vis_w_t_median=float(np.median(vis_w)) if vis_w else float("nan"))
    stage_summary = est.timers.summary()
    for stage, s in sorted(stage_summary.items(), key=lambda kv: -kv[1]["total_s"]):
        log.info("stage %-14s %6.1f ms/call x%-4d (%.2fs total)", stage, s["mean_ms"], s["count"],
                 s["total_s"])
    metrics.write(event="stage_summary", **{k: v["mean_ms"] for k, v in stage_summary.items()})
    metrics.close()
    tio.write_tum(args.output, ts, rs, ps)
    log.info("done: %d frames in %.1fs (%.2f fps), %d keyframes, %d landmarks, %d pose-graph "
             "edges (%d loop) -> %s", len(ts), wall, len(ts) / max(wall, 1e-9), n_kf,
             int(est.win.lm_alive.sum()), len(est.pg_edges), n_loop, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
