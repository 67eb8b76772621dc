"""Reference numbers of the JAX package for the PyTorch port's loop and
relocalization phases.

Renders a sequence with the port's generator (``vio360_tpu_torch.synthetic``,
torch on the CPU; ``--render loop`` or ``--render reloc``), or reads one
already written to DATASET, and runs ``vio360_tpu`` (JAX) over its frames
as monocular VO (no IMU rows; with ``--vio`` the dataset's IMU rows
are fed per frame) at ``VioConfig()`` defaults, or at ``--config``'s:
loop closure and the pose graph on (``--no-loop`` turns loop closure
off). Prints one JSON
line: the first frame that initializes, the keyframe count, the loop edges
and the frames that closed them, the frames lost and the first frame that
relocalized (with the database entry it relocalized against), and the sim3
ATE of the exported trajectory against ``groundtruth.tum``, whole and from
two frames after the relocalization on (the measure of
``tests/test_reloc.py``); with ``--vio`` also the frame that initialized
the IMU, the first loop after it, and the SE(3) ATE and scale error of the
whole trajectory (the measures of ``tools/evaluate_ate.py``).

    JAX_PLATFORMS=cpu python tools/jax_loop_reference.py OUT --render loop
    JAX_PLATFORMS=cpu python tools/jax_loop_reference.py OUT --no-loop
    JAX_PLATFORMS=cpu python tools/jax_loop_reference.py OUT2 --render reloc \\
        --config configs/synthetic_480.yaml
    JAX_PLATFORMS=cpu python tools/jax_loop_reference.py OUT3 --render vio --vio
    JAX_PLATFORMS=cpu python tools/jax_loop_reference.py OUT4 --render ckpt --vio \
        --config configs/synthetic_480.yaml --max-keyframes 4 --exclude-recent-kf 2 \
        --db-capacity 16 --paths megastep,sequential,staged

``loop``: 300 frames at 960x480, textured, three laps of the revisit
circuit, seed 41, pixel noise 0.05 (the geometry of ``tests/test_loop_e2e.py``
without its blur, exposure and vignette). ``reloc``: 90 frames at 480x240,
textured, seed 51, pixel noise 0.02, frames 45-54 blacked out, the
geometry and configuration of ``tests/test_reloc.py`` (at 960x480 and the
defaults the JAX package stays lost from frame 45 to the end). ``vio``:
100 frames at 960x480, textured, one lap of the revisit circuit, seed 41,
pixel noise 0.05, with its 200 Hz IMU stream: the shortest variant on
which the JAX package initializes the IMU and then verifies a loop
(``--frames 200 --laps 2``, the two-lap variant, closes its first at
frame 91). ``ckpt``: the 22-frame 480x240 blob sequence of
``tests/test_torch_checkpoint.py`` (seed 11, with its IMU stream); that
test's configuration is ``--config configs/synthetic_480.yaml
--max-keyframes 4 --exclude-recent-kf 2 --db-capacity 16``.
``chip_smoke.py``'s loop, relocalization and VIO-at-the-defaults bounds
are set from this script's output.

``--paths`` runs the JAX estimator once for each of its frame-loop paths
named and prints one line for each: ``megastep`` (the default: the
keyframe event folded into the frame program), ``sequential`` (the
megastep off, the fused keyframe event on) and ``staged`` (both off).
Each line adds the keyframe index of every loop frame (``loop_kf_index``),
the measure the port's tests compare first loops by.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SEQUENCES = {
    "loop": dict(frames=300, width=960, height=480, seed=41, texture=True, revisit=True, laps=3,
                 pixel_noise=0.05),
    "reloc": dict(frames=90, width=480, height=240, seed=51, texture=True, pixel_noise=0.02,
                  blackout=(45, 55)),
    "vio": dict(frames=100, width=960, height=480, seed=41, texture=True, revisit=True, laps=1,
                pixel_noise=0.05),
    "ckpt": dict(frames=22, width=480, height=240, seed=11),
}
#: the JAX estimator's frame-loop paths: (megastep, fused_keyframe)
PATHS = {"megastep": (True, True), "sequential": (False, True), "staged": (False, False)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("dataset_dir")
    p.add_argument("--render", choices=sorted(SEQUENCES), default=None,
                   help="write this sequence to DATASET first (port's generator)")
    p.add_argument("--no-loop", action="store_true", help="loop closure off")
    p.add_argument("--config", default=None, help="reference-format YAML config")
    p.add_argument("--vio", action="store_true", help="feed the dataset's IMU rows (VIO)")
    p.add_argument("--frames", type=int, default=None, help="override the rendered frame count")
    p.add_argument("--laps", type=int, default=None, help="override the rendered lap count")
    p.add_argument("--max-keyframes", type=int, default=None, help="window size override")
    p.add_argument("--exclude-recent-kf", type=int, default=None,
                   help="loop.exclude_recent_kf override")
    p.add_argument("--db-capacity", type=int, default=None, help="loop.db_capacity override")
    p.add_argument("--paths", default=None,
                   help="comma-separated frame-loop paths to run: " + ", ".join(PATHS))
    args = p.parse_args(argv)

    if args.render:
        from vio360_tpu_torch import synthetic

        seq = dict(SEQUENCES[args.render])
        seq.update({k: v for k, v in (("frames", args.frames), ("laps", args.laps)) if v})
        synthetic.make_dataset(args.dataset_dir, **seq)

    import dataclasses

    from vio360_tpu import config as cfgmod
    from vio360_tpu.io import dataset as ds

    cfg = cfgmod.load_yaml(args.config) if args.config else cfgmod.VioConfig()
    if args.no_loop:
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enabled=False))
    if args.max_keyframes:
        cfg = dataclasses.replace(cfg, window=dataclasses.replace(
            cfg.window, max_keyframes=args.max_keyframes))
    for key in ("exclude_recent_kf", "db_capacity"):
        if getattr(args, key) is not None:
            cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
                cfg.loop, **{key: getattr(args, key)}))
    data = ds.VioDataset(args.dataset_dir, image_size=(cfg.camera.width, cfg.camera.height),
                         use_native=False)
    if args.paths:
        for path in args.paths.split(","):
            mega, fused = PATHS[path]
            run_cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
                cfg.solver, megastep=mega, fused_keyframe=fused))
            print(json.dumps({"path": path, **_run(run_cfg, data, args)}), flush=True)
    else:
        print(json.dumps(_run(cfg, data, args)))
    return 0


def _run(cfg, data, args) -> dict:
    """One JAX estimator run over ``data`` -> the measures printed."""
    from vio360_tpu.estimator.estimator import Estimator
    from vio360_tpu.io import trajectory as tio
    from vio360_tpu.utils import metrics

    est = Estimator(cfg)
    results = []
    t0 = time.time()
    for frame in data:
        results.append(est.process_frame(frame.image, frame.timestamp,
                                         frame.imu if args.vio else None))
    wall = time.time() - t0
    ts, _, ps = est.export_trajectory()
    _, _, gt = tio.read_tum(os.path.join(args.dataset_dir, "groundtruth.tum"))
    states = [r.state for r in results]
    reloc = [r for r in results if r.state == "relocalized"]
    out = {
        "frames": len(ts),
        "init_frame": states.index("initialized") if "initialized" in states else -1,
        "keyframes": sum(int(r.is_keyframe) for r in results),
        "loop_edges": sum(e.kind == "loop" for e in est.pg_edges),
        "loop_frames": [r.frame_id for r in results if "loop_closed_to" in r.diag],
        "pg_edges": len(est.pg_edges),
        "pg_nodes": len(est.pg_nodes),
        "lost_frames": [r.frame_id for r in results if r.state == "tracking_lost"],
        "reloc_frame": reloc[0].frame_id if reloc else -1,
        "reloc_to": reloc[0].diag.get("reloc_to", -1) if reloc else -1,
        "ate_rmse_sim3": metrics.ate(ps, gt[:len(ps)], align="sim3").rmse,
        "wall_s": wall,
        "loop": not args.no_loop,
        "vio": args.vio,
        "config": args.config,
    }
    if reloc:
        f0 = reloc[0].frame_id + 2
        out["ate_rmse_sim3_after_reloc"] = metrics.ate(ps[f0:], gt[f0:len(ps)], align="sim3").rmse
        out["tracking_after_reloc"] = [s for s in states[reloc[0].frame_id + 1:]].count("tracking")
    if args.vio:
        imu = [r.frame_id for r in results if r.diag.get("imu_initialized")]
        out["imu_init_frame"] = imu[0] if imu else -1
        out["loop_frames_after_imu_init"] = [f for f in out["loop_frames"] if imu and f > imu[0]]
        out["ate_rmse_se3"] = metrics.ate(ps, gt[:len(ps)], align="se3").rmse
        out["scale_error"] = abs(metrics.ate(ps, gt[:len(ps)], align="sim3").scale - 1.0)
    kfs = [r.frame_id for r in results if r.is_keyframe]
    out["loop_kf_index"] = [kfs.index(f) for f in out["loop_frames"] if f in kfs]
    return out


if __name__ == "__main__":
    sys.exit(main())
