"""Reference numbers of the JAX package for the PyTorch port's VIO slice.

Runs ``vio360_tpu`` (JAX, on whatever platform JAX picks; ``JAX_PLATFORMS=cpu``
for the CPU) over a dataset directory with the configuration the port's
VIO slice runs: ``VioConfig()`` defaults, ``optical_flow.backend`` as given
(default ``matmul``), loop closure and the pose graph off, IMU rows fed
per frame. Prints one JSON line: the first frame that initializes, the
frame whose result reports ``imu_initialized``, the keyframe count, and
the SE(3) / sim3 ATE and scale error of the exported trajectory against
``groundtruth.tum`` (the measures of ``tools/evaluate_ate.py``).

    python tools/make_synthetic_dataset.py OUT --texture --seed 11 \\
        --width 960 --height 480
    JAX_PLATFORMS=cpu python tools/jax_vio_reference.py OUT

``chip_smoke.py``'s VIO bounds are set from this script's output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("dataset_dir")
    p.add_argument("--lk-backend", default="matmul", choices=["auto", "xla", "matmul", "pallas"])
    p.add_argument("--max-frames", type=int, default=None)
    args = p.parse_args(argv)

    from vio360_tpu import config as cfgmod
    from vio360_tpu.estimator.estimator import Estimator
    from vio360_tpu.io import dataset as ds
    from vio360_tpu.utils import metrics

    cfg = cfgmod.VioConfig()
    cfg = dataclasses.replace(
        cfg,
        optical_flow=dataclasses.replace(cfg.optical_flow, backend=args.lk_backend),
        loop=dataclasses.replace(cfg.loop, enabled=False),
        pose_graph=dataclasses.replace(cfg.pose_graph, enabled=False),
    )
    data = ds.VioDataset(args.dataset_dir, image_size=(cfg.camera.width, cfg.camera.height),
                         use_native=False)
    n = len(data) if args.max_frames is None else min(len(data), args.max_frames)
    est = Estimator(cfg)
    init_frame = imu_frame = -1
    n_kf = 0
    t0 = time.time()
    for frame in data:
        if frame.index >= n:
            break
        res = est.process_frame(frame.image, frame.timestamp, frame.imu)
        n_kf += int(res.is_keyframe)
        if res.state == "initialized" and init_frame < 0:
            init_frame = res.frame_id
        if res.diag.get("imu_initialized") and imu_frame < 0:
            imu_frame = res.frame_id
    wall = time.time() - t0
    ts, _, ps = est.export_trajectory()
    gt = np.loadtxt(os.path.join(args.dataset_dir, "groundtruth.tum"), ndmin=2)[:len(ts), 1:4]
    se3 = metrics.ate(ps, gt, align="se3")
    sim3 = metrics.ate(ps, gt, align="sim3")
    print(json.dumps({
        "frames": len(ts), "init_frame": init_frame, "imu_init_frame": imu_frame,
        "imu_initialized": bool(est.imu_initialized), "keyframes": n_kf,
        "ate_rmse_se3": se3.rmse, "ate_rmse_sim3": sim3.rmse,
        "scale_error": abs(sim3.scale - 1.0), "wall_s": wall, "lk_backend": args.lk_backend,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
