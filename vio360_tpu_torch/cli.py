"""Command-line VO / VIO runner (the port's main path).

Counterpart of ``vio360_tpu/cli.py``::

    python -m vio360_tpu_torch DATASET [--config cfg.yaml] [--output traj.tum] \\
        [--metrics m.jsonl] [--max-frames N] [--vo] [--no-loop] [--no-pose-graph] \\
        [--lk-backend matmul] [--image-transport u8|u16|f32] [--device cuda:0|cpu] \\
        [--checkpoint ck.npz [--checkpoint-every N]] [--resume ck.npz] \\
        [--step] [--pause-on-init] [--profile DIR] [--no-pipelined] [--solver-backend auto]

A dataset with IMU rows runs VIO unless ``--vo`` is given. Loop closure
and the pose graph are on, as in ``VioConfig()``; ``--no-loop`` /
``--no-pose-graph`` turn them off (the YAML loader reads no keys for
them). ``--device`` defaults to the card; without one the run stops with
an error unless ``--device cpu`` is given.

``--checkpoint`` writes the estimator's state at the end (before the
export's pose-graph solve), and every N frames with ``--checkpoint-every``;
``--resume`` continues from a checkpoint of the port or of the JAX package,
skipping the frames it already processed. ``--step`` pauses after every
frame and ``--pause-on-init`` once at initialization (Enter = next frame,
a number = run that many, c = continue, q = quit; end of input quits).
``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the frame
loop (host and, on the card, CUDA activity) to ``DIR/trace.json``. The
frame loop is the sequential ``process_frame``: the port's
``process_frame_async`` resolves each frame in its own call, so there is
no pipelined loop to turn off and ``--no-pipelined`` is accepted and
changes nothing.
``--solver-backend auto`` is the port's only solver backend (its kernels
on the card, their plain versions on the CPU).

Flags that need a part of the system not ported yet exit with code 2
and name it: ``--solver-backend xla|pallas|pallas-interpret``, ``--x64``,
``--viz-dir``, ``--viz-fps``, ``--mesh`` and ``--frames-per-dispatch`` > 1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import numpy as np

_REFUSED_FLAGS = {
    "mesh": "the distributed window solve (--mesh)",
    "x64": "double precision (--x64)",
    "viz_dir": "visualization output (--viz-dir)",
    "viz_fps": "visualization output (--viz-fps)",
}


def _refuse(what: str) -> int:
    print(f"error: not ported yet: {what}", file=sys.stderr)
    return 2


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vio360_tpu_torch",
                                description="360 VO / VIO on PyTorch + CUDA")
    p.add_argument("dataset_dir", help="dataset directory (images/ + cam_timestamps.txt)")
    p.add_argument("--config", default=None, help="reference-format YAML config")
    p.add_argument("--output", default="trajectory.tum", help="TUM trajectory output path")
    p.add_argument("--metrics", default=None, help="JSONL per-frame metrics path")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--vo", action="store_true", help="visual-only: ignore the IMU stream")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--no-loop", action="store_true", help="turn loop closure off")
    p.add_argument("--no-pose-graph", action="store_true", help="turn the pose graph off")
    p.add_argument("--no-pipelined", action="store_true",
                   help="accepted; the frame loop is sequential")
    p.add_argument("--image-transport", default=None, choices=["f32", "u8", "u16"])
    p.add_argument("--lk-backend", default=None, choices=["auto", "xla", "matmul", "pallas"],
                   help="LK front end: matmul = the matmul-gather LK, else the per-feature LK")
    p.add_argument("--solver-backend", default=None,
                   choices=["auto", "xla", "pallas", "pallas-interpret"],
                   help="auto only: the port's kernels (plain versions on the CPU)")
    p.add_argument("--device", default=None, help="torch device (default: cuda:0)")
    p.add_argument("--checkpoint", default=None, help="write a state snapshot here at the end")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also snapshot every N frames (requires --checkpoint)")
    p.add_argument("--resume", default=None, help="resume from a state snapshot")
    p.add_argument("--step", action="store_true",
                   help="pause after every frame (Enter = next, N = run N, c = continue, q = quit)")
    p.add_argument("--pause-on-init", action="store_true",
                   help="pause once when the estimator initializes")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run to DIR/trace.json")
    p.add_argument("--frames-per-dispatch", type=int, default=None, metavar="K")
    p.add_argument("--mesh", default=None, metavar="AXIS=N")
    p.add_argument("--x64", action="store_true")
    p.add_argument("--viz-dir", default=None)
    p.add_argument("--viz-fps", type=float, default=None)
    return p


def _profiler(device):
    """A torch.profiler context over the frame loop: host activity and, on
    the card, CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else []))


class _Stepper:
    """The JAX CLI's pause / step prompt (the reference's Pangolin pause
    and step UI, app/main.cpp:179-190) on stdin."""

    def __init__(self, step: bool, pause_on_init: bool, log):
        self.paused, self.pause_on_init, self.log = step, pause_on_init, log
        self.run_until, self.inited = -1, False

    def __call__(self, res) -> bool:
        """False when the user quits (q or end of input)."""
        if self.pause_on_init and not self.inited and res.state != "bootstrapping":
            self.inited = self.paused = True
            self.log.info("initialized at frame %d - paused (--pause-on-init)", res.frame_id)
        if not self.paused or res.frame_id < self.run_until:
            return True
        while True:
            try:
                cmd = input(f"[frame {res.frame_id} {res.state}{' KF' if res.is_keyframe else ''}] "
                            "Enter=step, N=run N, c=continue, q=quit> ").strip()
            except EOFError:
                return False
            if cmd == "":
                return True
            if cmd == "c":
                self.paused = False
                return True
            if cmd == "q":
                return False
            if cmd.isdigit():
                self.run_until = res.frame_id + int(cmd)
                return True


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)

    for flag, what in _REFUSED_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            return _refuse(what)
    if args.solver_backend not in (None, "auto"):
        return _refuse(f"the {args.solver_backend} solver backend "
                       f"(--solver-backend {args.solver_backend})")
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
    if args.resume and not os.path.isfile(args.resume):
        print(f"error: checkpoint not found: {args.resume}", file=sys.stderr)
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
    if args.resume:
        est = Estimator.load(args.resume, cfg, device=device)
        log.info("resumed from %s at frame %d", args.resume, est.frame_id)
    else:
        est = Estimator(cfg, device=device)
    log.info("dataset: %d frames, %d IMU samples on %s", n, data.imu.shape[0], est.device)
    metrics = MetricsWriter(args.metrics)
    interactive = args.step or args.pause_on_init
    stepper = _Stepper(args.step, args.pause_on_init, log) if interactive else None
    every = args.checkpoint_every if args.checkpoint else 0
    n_kf = 0

    def handle(res):
        nonlocal n_kf
        n_kf += int(res.is_keyframe)
        metrics.write(frame=res.frame_id, t=res.timestamp, state=res.state,
                      keyframe=res.is_keyframe, tracked=res.n_tracked, inliers=res.n_pnp_inliers,
                      **{k: v for k, v in res.diag.items() if np.isscalar(v)})
        if not args.quiet and (res.frame_id % 10 == 0 or res.is_keyframe):
            log.info("frame %4d  %-13s tracked=%4d inliers=%4d%s", res.frame_id, res.state,
                     res.n_tracked, res.n_pnp_inliers, "  [KF]" if res.is_keyframe else "")

    t0 = time.time()
    with _profiler(est.device) if args.profile else contextlib.nullcontext() as prof:
        for frame in data:
            if frame.index >= n:
                break
            if args.resume and frame.index <= est.frame_id:
                continue  # processed before the snapshot
            res = est.process_frame(frame.image, frame.timestamp, None if args.vo else frame.imu)
            if every and res.frame_id % every == 0:
                est.save(args.checkpoint)
            handle(res)
            if stepper is not None and not stepper(res):
                log.info("stopped at frame %d (interactive quit)", res.frame_id)
                break
        if est.device.type == "cuda":
            import torch

            torch.cuda.synchronize(est.device)
    wall = time.time() - t0
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        log.info("profiler trace written to %s", os.path.join(args.profile, "trace.json"))
    if args.checkpoint:
        est.save(args.checkpoint)  # before the export's pose-graph solve moves the history
        log.info("checkpoint written to %s", args.checkpoint)
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
