"""Reference numbers of the JAX package for the PyTorch port's loop and
relocalization phases.

Renders a sequence with the port's generator (``vio360_tpu_torch.synthetic``,
torch on the CPU; ``--render loop`` or ``--render reloc``), or reads one
already written to DATASET, and runs ``vio360_tpu`` (JAX) over its frames
as monocular VO (no IMU rows) at ``VioConfig()`` defaults, or at
``--config``'s: loop closure and the pose graph on (``--no-loop`` turns
loop closure off). Prints one JSON
line: the first frame that initializes, the keyframe count, the loop edges
and the frames that closed them, the frames lost and the first frame that
relocalized (with the database entry it relocalized against), and the sim3
ATE of the exported trajectory against ``groundtruth.tum``, whole and from
two frames after the relocalization on (the measure of
``tests/test_reloc.py``).

    JAX_PLATFORMS=cpu python tools/jax_loop_reference.py OUT --render loop
    JAX_PLATFORMS=cpu python tools/jax_loop_reference.py OUT --no-loop
    JAX_PLATFORMS=cpu python tools/jax_loop_reference.py OUT2 --render reloc \\
        --config configs/synthetic_480.yaml

``loop``: 300 frames at 960x480, textured, three laps of the revisit
circuit, seed 41, pixel noise 0.05 (the geometry of ``tests/test_loop_e2e.py``
without its blur, exposure and vignette). ``reloc``: 90 frames at 480x240,
textured, seed 51, pixel noise 0.02, frames 45-54 blacked out, the
geometry and configuration of ``tests/test_reloc.py`` (at 960x480 and the
defaults the JAX package stays lost from frame 45 to the end).
``chip_smoke.py``'s loop and relocalization bounds are set from this
script's output.
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
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("dataset_dir")
    p.add_argument("--render", choices=sorted(SEQUENCES), default=None,
                   help="write this sequence to DATASET first (port's generator)")
    p.add_argument("--no-loop", action="store_true", help="loop closure off")
    p.add_argument("--config", default=None, help="reference-format YAML config")
    args = p.parse_args(argv)

    if args.render:
        from vio360_tpu_torch import synthetic

        synthetic.make_dataset(args.dataset_dir, **SEQUENCES[args.render])

    import dataclasses

    from vio360_tpu import config as cfgmod
    from vio360_tpu.estimator.estimator import Estimator
    from vio360_tpu.io import dataset as ds
    from vio360_tpu.io import trajectory as tio
    from vio360_tpu.utils import metrics

    cfg = cfgmod.load_yaml(args.config) if args.config else cfgmod.VioConfig()
    if args.no_loop:
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enabled=False))
    data = ds.VioDataset(args.dataset_dir, image_size=(cfg.camera.width, cfg.camera.height),
                         use_native=False)
    est = Estimator(cfg)
    results = []
    t0 = time.time()
    for frame in data:
        results.append(est.process_frame(frame.image, frame.timestamp, None))
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
        "config": args.config,
    }
    if reloc:
        f0 = reloc[0].frame_id + 2
        out["ate_rmse_sim3_after_reloc"] = metrics.ate(ps[f0:], gt[f0:len(ps)], align="sim3").rmse
        out["tracking_after_reloc"] = [s for s in states[reloc[0].frame_id + 1:]].count("tracking")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
