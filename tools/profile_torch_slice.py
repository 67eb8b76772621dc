"""Where the time goes in a slice of the PyTorch port, on the card.

Runs the port's estimator over a dataset twice: once to time every frame
on the host clock (each frame ends in a device sync), once under
``torch.profiler`` over the frames [--from, --to). Prints the per-frame
medians of tracking and keyframe frames, the stage means, and for the
profiled window its wall time, the device's busy time (union of kernel
and copy intervals), the launch count and the device time by kernel,
the LM iteration count of each window-BA launch (K2) in the window, the
landmarks, batch size and LM iterations of each PnP launch (K1) there,
the Gauss-Newton steps of each per-feature LK launch (K4) there, and the
host operators that took the most host time there. Loop closure and the
pose graph are off unless ``--loop`` is given (the defaults).
The last line of standard output is a JSON summary.

    python tools/profile_torch_slice.py DATASET [--lk-backend matmul] [--vo] [--loop] \\
        [--from 20] [--to 40] [--device cuda:0]

With ``--render DIR`` the 40-frame 960x480 textured sequence of seed 11
(``vio360_tpu_torch.synthetic.make_dataset``, with IMU) is written to
DIR first and used as DATASET.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


_FRAME = [0]  # index of the frame being processed, for the K1 / K2 / K4 work records


def _run(est, data, n, imu: bool, window=None, prof_ctx=None):
    import torch

    times, kinds = [], []
    for f in data:
        if f.index >= n:
            break
        _FRAME[0] = f.index
        if window is not None and f.index == window[0]:
            prof_ctx.__enter__()
            torch.cuda.synchronize()
            t_win = time.perf_counter()
        t0 = time.perf_counter()
        res = est.process_frame(f.image, f.timestamp, f.imu if imu else None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        kinds.append("kf" if res.is_keyframe else res.state)
        if window is not None and f.index == window[1] - 1:
            wall = time.perf_counter() - t_win
            prof_ctx.__exit__(None, None, None)
            return times, kinds, wall
    return times, kinds, None


def _busy_ms(events) -> float:
    """Union of device intervals (us) -> ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("dataset_dir")
    p.add_argument("--render", action="store_true", help="write the seed-11 sequence there first")
    p.add_argument("--lk-backend", default="auto", choices=["auto", "xla", "matmul", "pallas"])
    p.add_argument("--vo", action="store_true", help="ignore the IMU stream")
    p.add_argument("--from", dest="start", type=int, default=20)
    p.add_argument("--to", dest="stop", type=int, default=40)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--loop", action="store_true", help="loop closure and pose graph on")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vio360_tpu_torch import config as cfgmod, synthetic
    from vio360_tpu_torch.estimator.estimator import Estimator
    from vio360_tpu_torch.io.dataset import VioDataset

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    # build and load every kernel first, so no stage mean holds an nvcc run
    from vio360_tpu_torch import cuda_build
    from vio360_tpu_torch.ops import gather_cuda, lk_cuda
    from vio360_tpu_torch.solver import ba_cuda

    for lib, sigs in (("lm_solve", ba_cuda._SIGS), ("lk_pyr", lk_cuda._SIGS),
                      ("gather_win", gather_cuda._SIGS)):
        cuda_build.load(lib, sigs)
    if args.render:
        synthetic.make_dataset(args.dataset_dir, frames=40, width=960, height=480, seed=11,
                               texture=True, device=args.device)
    cfg = cfgmod.VioConfig()
    cfg = dataclasses.replace(cfg, optical_flow=dataclasses.replace(cfg.optical_flow,
                                                                     backend=args.lk_backend))
    if not args.loop:
        cfg = dataclasses.replace(cfg, loop=cfgmod.LoopConfig(enabled=False),
                                  pose_graph=cfgmod.PoseGraphConfig(enabled=False))
    data = VioDataset(args.dataset_dir, image_size=(cfg.camera.width, cfg.camera.height))
    n = min(len(data), args.stop)

    # K2's and K1's LM iteration counts and K4's Gauss-Newton steps per
    # launch in the unprofiled run (read after it)
    k2_iters, k1_iters, solve, pnp_launch = [], [], ba_cuda.ba_solve, ba_cuda._pnp_launch
    k4_work, lk_launch = [], lk_cuda.launch

    def recording_lk(prep, *a, **kw):
        work = torch.empty(prep.uv_prev.shape[0], 3, dtype=torch.int32, device=prep.uv_prev.device)
        k4_work.append((_FRAME[0], work))
        return lk_launch(prep, *a, work=work, **kw)

    def recording_solve(*a, **kw):
        out = solve(*a, **kw)
        k2_iters.append((_FRAME[0], out[4]))
        return out

    def recording_pnp(*a, **kw):
        out = pnp_launch(*a, **kw)
        k1_iters.append((_FRAME[0], a[2].shape[-2], out[6].reshape(-1)))
        return out

    ba_cuda.ba_solve, ba_cuda._pnp_launch, lk_cuda.launch = recording_solve, recording_pnp, recording_lk
    est = Estimator(cfg, device=args.device)
    times, kinds, _ = _run(est, data, n, not args.vo)
    ba_cuda.ba_solve, ba_cuda._pnp_launch, lk_cuda.launch = solve, pnp_launch, lk_launch
    stages = {k: v["mean_ms"] for k, v in est.timers.summary().items()}
    med = lambda sel: statistics.median(sel) * 1e3 if sel else None
    after = range(args.start, n)
    track_ms = med([times[i] for i in after if kinds[i] in ("tracking", "tracking_lost")])
    kf_ms = med([times[i] for i in after if kinds[i] == "kf"])

    ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    est = Estimator(cfg, device=args.device)
    _, _, wall = _run(est, data, n, not args.vo, (args.start, n), ctx)
    events = [e for e in ctx.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_ms(events)
    by_kernel = {}
    for e in events:
        by_kernel.setdefault(e.name, [0.0, 0])
        by_kernel[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_kernel[e.name][1] += 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"device {torch.cuda.get_device_name(0)}; frames {args.start}-{n - 1} "
          f"({args.lk_backend}, {'VO' if args.vo else 'VIO'})")
    print(f"unprofiled: tracking frame median {track_ms} ms, keyframe frame median {kf_ms} ms")
    print("stage means (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(stages.items())))
    print(f"profiled window: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({busy / (wall * 1e3):.3f}), {len(events)} device events")
    for name, (ms, cnt) in top:
        print(f"  {ms:9.2f} ms  x{cnt:6d}  {name[:90]}")
    host = sorted(ctx.key_averages(), key=lambda a: -a.self_cpu_time_total)[:12]
    print("host time by operator (self):")
    for a in host:
        print(f"  {a.self_cpu_time_total / 1e3:9.2f} ms  x{a.count:6d}  {a.key[:90]}")
    iters = [int(it) for fr, it in k2_iters if fr >= args.start]
    print(f"K2 (window BA) launches in frames {args.start}-{n - 1}: {len(iters)}, LM iterations "
          f"{iters}")
    pnp = [(m, it.tolist()) for fr, m, it in k1_iters if fr >= args.start]
    print(f"K1 (PnP) launches in frames {args.start}-{n - 1}: {len(pnp)} (B = 4: "
          f"{sum(len(it) == 4 for _, it in pnp)}), landmarks {sorted({m for m, _ in pnp})}, LM "
          f"iterations over the rounds per problem {[it for _, it in pnp]}")
    k4 = [w[:, 0].double() for fr, w in k4_work if fr >= args.start]
    k4_sum = [int(w.sum()) for w in k4]
    print(f"K4 (per-feature LK) launches in frames {args.start}-{n - 1}: {len(k4)}, Gauss-Newton "
          f"steps per launch {k4_sum}, mean per feature "
          f"{sum(k4_sum) / max(sum(w.numel() for w in k4), 1):.2f}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "frames": [args.start, n - 1],
        "lk_backend": args.lk_backend, "vio": not args.vo, "tracking_frame_ms": track_ms,
        "keyframe_frame_ms": kf_ms, "stage_mean_ms": stages, "window_wall_ms": wall * 1e3,
        "device_busy_ms": busy, "device_events": len(events),
        "top_kernels_ms": {k: v[0] for k, v in top}, "k2_iterations": iters,
        "k1_iterations": [it for _, it in pnp], "k4_steps": k4_sum,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
