#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build: ``nvcc`` builds every kernel for sm_90a from
   ``vio360_tpu_torch/csrc``, one process per source, all at once
   (ptxas register / shared-memory summary);
3. kernels: each kernel (K1-K5) against its plain PyTorch version on the
   card at the main paths' shapes, with the stated tolerances, the
   kernel's median device time per launch (torch.profiler) beside its
   wrapper's (CUDA events around the call, after warm-up), the least time the card could
   take for the same work, and the time of one PyTorch call computing
   the same function where there is one; K1, K2 and K4 twice on the
   same inputs must return equal tensors (and iteration or step counts);
   K2 (one cluster of 16 CTAs) is also timed on a sliding-window problem
   (each landmark seen by 3 consecutive keyframes of 10); K4 is timed
   alone on prepared buffers and with its wrapper, and its bound counts
   the Gauss-Newton steps and templates the kernel reports; K1 also over
   a batch of B = 4 problems in one launch (three that succeed, one with
   too few inliers), each equal bit for bit to its own B = 1 launch;
4. lk_matmul: the matmul-gather LK on the card against the same call on
   the CPU;
5. the VO slice: render the 40-frame 960x480 textured sequence (seed 11)
   with ``vio360_tpu_torch.synthetic``, run the port's CLI on it with
   ``--vo`` (per-feature LK, K4; loop closure and pose graph off, as in
   the JAX run that sets its bound) with every launch counter at 0, and
   check that it initializes, makes >= 3 keyframes, launches every kernel
   of the path, and stays within the sim3 ATE bound set by the JAX
   package on the same sequence;
6. the VIO slice: the same sequence with its IMU stream through the CLI
   at ``--lk-backend matmul`` (K5), counters at 0 again; it must
   initialize, initialize the IMU, make >= 3 keyframes, launch K5, K1
   and K2, and stay within the SE(3) ATE and scale-error bounds set by
   the JAX package (``tools/jax_vio_reference.py``);
7. the loop slice: render the 300-frame 960x480 three-lap revisit
   sequence (seed 41, pixel noise 0.05) and run the CLI on it with
   ``--vo`` at the defaults (loop closure and pose graph on); it must
   record eviction edges with covariance weights, close a verified loop,
   launch K1 with B = 4, run the Sim(3) graph at export and stay within
   the sim3 ATE bound set by the JAX package; then once with
   ``--no-loop`` for information;
8. relocalization: a 90-frame 480x240 sequence (seed 51) blacked out
   for frames 45-54, through the CLI with ``--vo`` and
   configs/synthetic_480.yaml; it must lose tracking in the blackout,
   relocalize within 2 frames of the JAX package, track on every frame
   after that and stay within the JAX bound on the ATE after it
   (``tools/jax_loop_reference.py`` gives the JAX numbers of 7, 8 and 10);
9. resume: on phase 7's sequence, the CLI with ``--vo --max-frames 150
   --checkpoint``, then ``--vo --resume`` of that checkpoint under
   ``--profile``; the resumed trajectory must equal phase 7's bit for bit
   (the TUM text), with the same verified loops and pose-graph counts, and
   the profiler's trace must name ``lk_kernel``, ``pnp_kernel`` and
   ``ba_kernel``;
10. VIO at the defaults: render the 100-frame 960x480 one-lap revisit
   sequence (seed 41, pixel noise 0.05) and run the CLI on it with its IMU
   stream at the defaults (loop closure and the pose graph with IMU edges
   on, per-feature LK); it must initialize the IMU, verify a loop after
   that, launch K1, K2 and K4, and stay within the SE(3) ATE and
   scale-error bounds set by the JAX package on the same frames.

Every ATE comes from the port's own evaluator
(``vio360_tpu_torch.utils.metrics.evaluate_tum``), in this process. The
last lines of standard output are each phase's wall time, ``nvidia-smi``'s
name and power limit, the kernels record and ``{"ok": true, "device":
{...}}``. Imports nothing of JAX and runs no script of the repo in a
subprocess.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# sim3 ATE (m) of the JAX package (vio360_tpu, CPU, XLA backends) on this
# sequence with the slice configuration; the port must stay within
# max(2x, +0.02) of it.
JAX_ATE = 0.002386132107592164
ATE_BOUND = max(2.0 * JAX_ATE, JAX_ATE + 0.02)

# SE(3) ATE (m) and scale error of the JAX package's VIO (CPU, lk backend
# matmul, loop closure and pose graph off) on the same sequence with its
# IMU stream, from tools/jax_vio_reference.py; it initializes at frame 9
# and initializes the IMU there. Bounds: max(2x, +0.02) of each.
JAX_VIO_ATE_SE3 = 0.014014553732509413
JAX_VIO_SCALE_ERR = 0.01715706788553728
VIO_ATE_BOUND = max(2.0 * JAX_VIO_ATE_SE3, JAX_VIO_ATE_SE3 + 0.02)
VIO_SCALE_BOUND = max(2.0 * JAX_VIO_SCALE_ERR, JAX_VIO_SCALE_ERR + 0.02)

# The JAX package (CPU) on the loop and relocalization sequences, VO, loop
# closure and pose graph on (tools/jax_loop_reference.py). Loop: 300
# frames 960x480 at the defaults, sim3 ATE with loops and without (for
# information). Relocalization: 90 frames 480x240 with
# configs/synthetic_480.yaml, the first relocalized frame and the sim3
# ATE from two frames after it on. Bounds: max(2x, +0.02).
JAX_LOOP_ATE = 0.027890215461344164
JAX_NOLOOP_ATE = 0.011975448197291357
JAX_RELOC_FRAME = 55
JAX_RELOC_ATE = 0.017858938024951223
LOOP_ATE_BOUND = max(2.0 * JAX_LOOP_ATE, JAX_LOOP_ATE + 0.02)
# The JAX package (CPU) on the VIO-at-the-defaults sequence (100 frames
# 960x480, one lap of the revisit circuit, seed 41, pixel noise 0.05, its
# IMU stream; loop closure and pose graph on), from ``JAX_PLATFORMS=cpu
# python tools/jax_loop_reference.py OUT --render vio --vio``: it
# initializes the IMU at frame 9 and verifies 9 loops, the first at frame
# 50 (on the two-lap 200-frame sequence, the starting point, its first
# loop came at frame 91). Bounds: max(2x, +0.02).
JAX_DVIO_ATE_SE3 = 0.00817712463262061
JAX_DVIO_SCALE_ERR = 0.0020621230681753255
JAX_DVIO_IMU_INIT_FRAME = 9
JAX_DVIO_FIRST_LOOP = 50
JAX_DVIO_LOOPS = 9
DVIO_ATE_BOUND = max(2.0 * JAX_DVIO_ATE_SE3, JAX_DVIO_ATE_SE3 + 0.02)
DVIO_SCALE_BOUND = max(2.0 * JAX_DVIO_SCALE_ERR, JAX_DVIO_SCALE_ERR + 0.02)
RELOC_ATE_BOUND = max(2.0 * JAX_RELOC_ATE, JAX_RELOC_ATE + 0.02)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores (every kernel here computes in f32).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
LIBS = ("lm_solve", "lk_pyr", "gather_win")


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms (CUDA events, one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int) -> float:
    """Median device time (ms) of one launch of the kernel whose name
    contains ``kernel``, over ``reps`` calls of ``fn`` (torch.profiler's
    device events, after one warm-up call): the kernel alone, without the
    host work of its wrapper."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    lead_in = torch.zeros(1, device="cuda")
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # the first device events of a profiling session can go unrecorded:
            # let them be these, not the kernel's
            for _ in range(3):
                lead_in.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(times) == reps:
            return statistics.median(times)
        # the profiler has been seen to drop a device event now and then
        log(f"[profiler] saw {len(times)} launches of {kernel}, expected {reps}" +
            ("; measuring again" if attempt == 0 else ""))
    check(False, f"the profiler saw {len(times)} launches of {kernel}, expected {reps}")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(nbytes: float, flops: float) -> dict:
    """The least time (ms) the card could take for the work: the larger of
    bytes over the memory rate and operations over the f32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return name, count


def phase_build():
    from vio360_tpu_torch import cuda_build

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(LIBS)) as pool:
        for lib, _ in zip(LIBS, pool.map(cuda_build.build, LIBS)):
            log(f"[build] {lib} done at {time.time() - t0:.1f}s")
    for lib in LIBS:
        for line in cuda_build.PTXAS_LOG[lib].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[ptxas] {line.strip()}")
    from vio360_tpu_torch.solver import ba_cuda

    for k in (10, 16):
        log(f"[K2 launch shape K={k}] {ba_cuda.ba_launch_info(k)}")


def _texture_pair(dev):
    import torch

    from vio360_tpu_torch import synthetic
    from vio360_tpu_torch.geometry import lie

    pano = synthetic.make_panorama(88, 960, 1920, octaves=6, device=dev)
    r0 = torch.eye(3, device=dev)
    r1 = lie.so3_exp(torch.tensor([0.0, 0.03, 0.01], device=dev))
    img0 = synthetic.render_textured_view(pano, r0, torch.zeros(3, device=dev), 960, 480)
    img1 = synthetic.render_textured_view(pano, r1, torch.tensor([0.05, 0.0, 0.1], device=dev), 960, 480)
    return img0, img1


def lk_problem(dev) -> tuple:
    """K4's main-path inputs: the textured 960x480 pair and up to 1024
    Shi-Tomasi corners of the first image outside the polar band."""
    import torch

    from vio360_tpu_torch.geometry import camera as cam
    from vio360_tpu_torch.ops import shi_tomasi

    img0, img1 = _texture_pair(dev)
    allowed = cam.polar_mask(960, 480, 0.15, device=dev)
    uv, _, valid = shi_tomasi.detect(img0, allowed, torch.zeros(1, 2, device=dev),
                                     torch.zeros(1, dtype=torch.bool, device=dev), max_new=1024,
                                     min_distance=8.0, quality_level=0.001)
    check(uv.shape == (1024, 2) and int(valid.sum()) > 500, "LK: too few features to track")
    return img0, img1, uv, valid


def lk_bound(n: int, num_levels: int, work, half: int = 10, h: int = 480, w: int = 960) -> dict:
    """K4's bound for this run's work: bytes = both pyramids read once plus
    the per-feature inputs (uv_prev, uv_guess, valid: 17 B) and outputs (uv,
    status, err: 13 B); operations = per Gauss-Newton step and window pixel
    an interpolation, a difference and two products (14), per template the
    Scharr stencil at the (p+1)^2 integer positions (24 each) and three
    interpolations and the G sums per pixel (33), per feature the err pass
    (12 per pixel), with the steps and templates the kernel counted
    (``work``, [N, 3])."""
    px = sum(((h + (1 << k) - 1) >> k) * ((w + (1 << k) - 1) >> k) for k in range(num_levels + 1))
    p = 2 * half + 1
    steps, templates = (float(x) for x in work[:, :2].double().sum(0))
    flops = steps * p * p * 14 + templates * ((p + 1) ** 2 * 24 + p * p * 33) + n * p * p * 12
    return bound(2 * px * 4 + n * 30, flops)


def pnp_problem(dev, m: int = 1024, seed: int = 9, n_active: int | None = None) -> tuple:
    """``pnp_solve``'s arguments for K1's main-path shape: M landmarks in
    front of the camera, 0.5 px noise, 60 gross outliers, 90% active and
    5% marginalized slots, from ``seed`` (9 on the main path); with
    ``n_active`` only the first that many active slots stay active."""
    import numpy as np
    import torch

    from vio360_tpu_torch.geometry import camera as cam, lie

    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pts = t(rng.uniform(-5, 5, (m, 3)) + np.array([0, 0, 7.0]))
    r_true = lie.so3_exp(t([0.03, -0.02, 0.01]))
    t_true = t([0.15, -0.1, 0.2])
    r_cb, t_cb = lie.so3_exp(t([0.01, 0.02, -0.01])), t([0.02, 0.01, 0.0])
    p_c = ((pts - t_true) @ r_true) @ r_cb.T + t_cb
    obs = cam.project(p_c, 960, 480) + t(rng.standard_normal((m, 2)) * 0.5)
    out_idx = torch.as_tensor(rng.choice(m, 60, replace=False), device=dev)
    obs[out_idx] += t(rng.uniform(30, 60, (60, 2)))
    active = torch.as_tensor(rng.random(m) < 0.9, device=dev)
    marg = torch.as_tensor(rng.random(m) < 0.05, device=dev)
    if n_active is not None:
        active &= torch.cumsum(active.int(), 0) <= n_active
    return (torch.eye(3, device=dev), torch.zeros(3, device=dev), pts, obs, active, marg, 1e-4,
            r_cb, t_cb, 960, 480, 1.0, 1.0, 5.991, 4, 50)


def ba_problem(dev, k: int, seed: int, window: int | None = None) -> tuple:
    """``ba_solve``'s arguments (before ``max_iterations``) for K2's
    main-path shape: K keyframes, M = 2048 landmarks, 70% of the
    (keyframe, landmark) pairs observed -- or with ``window`` each
    landmark seen by that many consecutive keyframes, as in the sliding
    window -- the oldest pose and 10% of the landmarks fixed."""
    import numpy as np
    import torch

    from vio360_tpu_torch.geometry import camera as cam, lie

    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    mm = 2048
    pts = t(rng.uniform(-5, 5, (mm, 3)) + np.array([0, 0, 7.0]))
    rs = lie.so3_exp(t(rng.uniform(-0.05, 0.05, (k, 3))))
    ts = t(np.cumsum(rng.uniform(-0.05, 0.08, (k, 3)), 0))
    rcb, tcb = lie.so3_exp(t([0.02, -0.01, 0.03])), t([0.01, 0.0, -0.02])
    p_b = torch.einsum("kji,mj->kmi", rs, pts) - torch.einsum("kji,kj->ki", rs, ts)[:, None]
    uv = cam.project(torch.einsum("ij,kmj->kmi", rcb, p_b) + tcb, 960, 480)
    uv = uv + t(rng.standard_normal((k, mm, 2)) * 0.5)
    if window is None:
        mask = torch.as_tensor(rng.random((k, mm)) < 0.7, device=dev)
    else:
        first = rng.integers(0, k - window + 1, mm)
        kk = np.arange(k)[:, None]
        mask = torch.as_tensor((kk >= first) & (kk < first + window), device=dev)
    fixed_pose = torch.zeros(k, dtype=torch.bool, device=dev)
    fixed_pose[0] = True
    fixed_point = torch.as_tensor(rng.random(mm) < 0.1, device=dev)
    ts_p = ts + t(rng.normal(0, 0.03, (k, 3)))
    ts_p[0] = ts[0]
    return (rs, ts_p, pts, uv, mask.float(), fixed_pose, fixed_point, 1e-4, rcb, tcb, 960, 480,
            1.0, 1.0, False)


def phase_kernels(dev):
    """Each kernel vs its plain version at main-path shapes -> records."""
    import torch

    from vio360_tpu_torch.geometry import camera as cam
    from vio360_tpu_torch.ops import lk_cuda
    from vio360_tpu_torch.solver import ba_cuda

    out = {}
    # ---- K4: LK at 960x480, N = 1024, 4 and 3 levels ----
    img0, img1, uv, valid = lk_problem(dev)
    errs, ms, wrapper_ms, plain_ms, works = [], [], [], [], []
    for num_levels in (3, 2):
        args = (img0, img1, uv, valid, None, num_levels, 10, 30, 0.01)
        uv_k, st_k, _ = lk_cuda.track(*args)
        uv_p, st_p, _ = lk_cuda.track_plain(*args)
        torch.cuda.synchronize()
        both = st_k & st_p
        # The tracker drops every track that ends in the polar band or the
        # boundary margin right after LK (frontend/tracker.py, step 2); a
        # feature that drifts there has no defined answer to agree on.
        kept = both & ~cam.is_in_polar_region(uv_p, 480, 0.15) & ~cam.is_near_boundary(uv_p, 960, 480, 20.0)
        diff = (uv_k - uv_p).abs().max(1).values
        err = float(diff[kept].max())
        n_k, n_p = int(st_k.sum()), int(st_p.sum())
        dropped = both & ~kept
        log(f"[K4 lk_pyr levels={num_levels + 1}] status kernel {n_k} plain {n_p}; max |duv| "
            f"{err:.3e} px on {int(kept.sum())} both-tracked kept features; "
            f"{int(dropped.sum())} both-tracked features end in the polar band / margin "
            f"(max |duv| there {float(diff[dropped].max()) if bool(dropped.any()) else 0.0:.3e} px)")
        check(n_k >= 0.98 * n_p and err < 1e-2, f"K4 disagrees at {num_levels + 1} levels")
        errs.append(err)
        prep = lk_cuda.prepare(img0, img1, uv, valid, None, num_levels)
        runs = []
        for _ in range(2):
            work = torch.empty(uv.shape[0], 3, dtype=torch.int32, device=dev)
            runs.append((*lk_cuda.launch(prep, 10, 30, 0.01, work=work), work))
        check(all(torch.equal(a, b) for a, b in zip(*runs)), "K4 is not deterministic")
        works.append(runs[0][3])
        steps = runs[0][3][:, 0].double()
        log(f"[K4 lk_pyr levels={num_levels + 1}] two calls equal; Gauss-Newton steps: sum "
            f"{int(steps.sum())}, mean {float(steps.mean()):.2f} per feature, "
            f"{float(steps[valid].mean()):.2f} per valid feature, max {int(steps.max())}; "
            f"templates {int(runs[0][3][:, 1].sum())}; J patches staged "
            f"{int(runs[0][3][:, 2].sum())}")
        ms.append(device_ms(lambda: lk_cuda.launch(prep, 10, 30, 0.01), "lk_kernel", 20))
        wrapper_ms.append(timed_ms(lambda: lk_cuda.track(*args), 20))
        plain_ms.append(timed_ms(lambda: lk_cuda.track_plain(*args), 3))
        log(f"[K4 lk_pyr levels={num_levels + 1}] kernel {ms[-1]:.4f} ms, wrapper (pyramids, "
            f"kernel) {wrapper_ms[-1]:.4f} ms vs plain {plain_ms[-1]:.3f} ms; bound "
            f"{lk_bound(uv.shape[0], num_levels, works[-1])}")
    out["lk_pyr"] = dict(max_abs_err=max(errs), ms=ms[0], wrapper_ms=wrapper_ms[0],
                         plain_ms=plain_ms[0], library_ms=None,
                         **lk_bound(uv.shape[0], 3, works[0]))

    # ---- K1: PnP at M = 1024 ----
    m = 1024
    pargs = pnp_problem(dev, m)
    kr = ba_cuda.pnp_solve(*pargs)
    pr = ba_cuda._pnp_plain(*pargs)
    torch.cuda.synchronize()
    dt_ = float((kr[1] - pr[1]).abs().max())
    dr_ = float((kr[0] - pr[0]).abs().max())
    dinl = abs(int(kr[4]) - int(pr[4]))
    log(f"[K1 lm_pnp M={m}] |dt| {dt_:.3e} |dR| {dr_:.3e} inliers {int(kr[4])} vs {int(pr[4])}")
    check(dt_ < 5e-3 and dr_ < 5e-4 and dinl <= 3, "K1 disagrees with its plain version")
    k1a, k1b = ba_cuda._pnp_launch(*pargs), ba_cuda._pnp_launch(*pargs)
    check(all(torch.equal(a, b) for a, b in zip(k1a, k1b)), "K1 is not deterministic")
    k1_iters = int(k1a[6])
    log(f"[K1 lm_pnp M={m}] two calls equal (incl. {k1_iters} LM iterations over 4 rounds)")
    k_ms = device_ms(lambda: ba_cuda.pnp_solve(*pargs), "pnp_kernel", 20)
    w_ms = timed_ms(lambda: ba_cuda.pnp_solve(*pargs), 20)
    p_ms = timed_ms(lambda: ba_cuda._pnp_plain(*pargs), 3)
    log(f"[K1 lm_pnp M={m}] kernel {k_ms:.4f} ms, wrapper {w_ms:.4f} ms vs plain {p_ms:.3f} ms")
    # bytes: points, observations and masks in, pose / outlier out;
    # operations: one pass over the M landmarks (~300 flops each: transform,
    # projection, Jacobian, normal equations) per LM iteration, plus the
    # first linearization and the chi2 pass of each of the 4 rounds
    out["lm_pnp"] = dict(max_abs_err=max(dt_, dr_), ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms,
                         library_ms=None, **pnp_bound(m, [k1_iters]))
    out["lm_pnp"]["batched"] = phase_pnp_batched(dev, m, k1a)

    # ---- K2 (K = 10 and 2) and K3 (K = 10) at M = 2048 ----
    def ba_flops(args, iters):
        # per LM iteration: per observation Jacobian + weighted normal
        # blocks (~300), per free landmark its Schur cross terms (nobs^2 *
        # 6*6*3*2 for the keyframes that observe it) and the 6K x 6K
        # elimination
        mask, fixed_point = args[4], args[6]
        k = mask.shape[0]
        nobs = mask.sum(0)
        pairs = float((nobs * nobs)[~fixed_point].sum())
        return iters * (float(mask.sum()) * 300 + pairs * 216 + (6 * k) ** 3 / 3)

    def ba_bytes(k, mm):
        return k * mm * 12 + mm * 13 + k * 12 * 2 + mm * 12

    def ba_check(label, bargs):
        kk = ba_cuda.ba_solve(*bargs, max_iterations=50)
        pp = ba_cuda._ba_plain(*bargs, 50)
        again = ba_cuda.ba_solve(*bargs, max_iterations=50)
        torch.cuda.synchronize()
        rel = abs(float(kk[3]) - float(pp[3])) / max(float(pp[3]), 1e-9)
        dpose = max(float((kk[0] - pp[0]).abs().max()), float((kk[1] - pp[1]).abs().max()))
        same = all(torch.equal(a, b) for a, b in zip(kk, again))
        log(f"[K2 lm_ba_solve {label}] cost {float(kk[3]):.4f} vs {float(pp[3]):.4f} "
            f"(rel {rel:.2e}), iters {int(kk[4])} vs {int(pp[4])}, max |dpose| {dpose:.3e}; "
            f"two calls equal: {same}")
        check(rel < 0.02 and dpose < 5e-3, f"K2 disagrees ({label})")
        check(same, f"K2 is not deterministic ({label})")
        return kk, dpose

    ba_err = []
    for k in (10, 2):
        bargs = ba_problem(dev, k, 5 + k)
        kk, dpose = ba_check(f"K={k} M=2048", bargs)
        ba_err.append(dpose)
        if k == 10:
            ba_ms = device_ms(lambda: ba_cuda.ba_solve(*bargs, max_iterations=50), "ba_kernel", 10)
            ba_w_ms = timed_ms(lambda: ba_cuda.ba_solve(*bargs, max_iterations=50), 10)
            ba_plain_ms = timed_ms(lambda: ba_cuda._ba_plain(*bargs, 50), 2)
            log(f"[K2 lm_ba_solve K=10 M=2048] kernel {ba_ms:.4f} ms ({int(kk[4])} iterations), "
                f"wrapper {ba_w_ms:.4f} ms vs plain {ba_plain_ms:.3f} ms")
            ba_bound = bound(ba_bytes(k, 2048), ba_flops(bargs, max(int(kk[4]), 1)))
    sargs = ba_problem(dev, 10, 31, window=3)
    ks, dpose = ba_check("K=10 M=2048, 3 consecutive keyframes per landmark", sargs)
    ba_err.append(dpose)
    s_ms = device_ms(lambda: ba_cuda.ba_solve(*sargs, max_iterations=50), "ba_kernel", 10)
    s_bound = bound(ba_bytes(10, 2048), ba_flops(sargs, max(int(ks[4]), 1)))
    log(f"[K2 lm_ba_solve sliding window K=10 M=2048] {s_ms:.3f} ms ({int(ks[4])} iterations), "
        f"bound {s_bound['bound_ms']:.5f} ms ({s_bound['bound_by']})")
    out["lm_ba_solve"] = dict(max_abs_err=max(ba_err), ms=ba_ms, wrapper_ms=ba_w_ms,
                              plain_ms=ba_plain_ms, library_ms=None, **ba_bound)

    bargs = ba_problem(dev, 10, 15)
    kk = ba_cuda.ba_iteration(*bargs)
    pp = ba_cuda._ba_plain(*bargs, None)
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, r in zip(["r", "t", "pts", "cur_cost", "new_cost", "step"], kk, pp):
        scale = max(1.0, float(r.abs().max()))
        e = float((g - r).abs().max())
        worst = max(worst, e / scale)
        check(e <= 2e-3 * scale + 2e-3 * float(r.abs().max()), f"K3 disagrees on {name}: {e}")
    k3_ms = device_ms(lambda: ba_cuda.ba_iteration(*bargs), "ba_kernel", 20)
    k3_w_ms = timed_ms(lambda: ba_cuda.ba_iteration(*bargs), 20)
    k3_plain = timed_ms(lambda: ba_cuda._ba_plain(*bargs, None), 3)
    log(f"[K3 lm_ba_iteration K=10 M=2048] max scaled err {worst:.3e}; kernel {k3_ms:.4f} ms, "
        f"wrapper {k3_w_ms:.4f} ms vs plain {k3_plain:.3f} ms (off the main path: tests only)")
    out["lm_ba_iteration"] = dict(max_abs_err=worst, ms=k3_ms, wrapper_ms=k3_w_ms, plain_ms=k3_plain,
                                  library_ms=None,
                                  **bound(ba_bytes(10, 2048), ba_flops(bargs, 1)))
    out["gather_win"] = phase_gather(dev, img0, img1, uv, valid)
    return out


def pnp_bound(m: int, iters: list) -> dict:
    """K1's bound for problems of M landmarks that took ``iters`` LM
    iterations each: bytes = points, observations and masks in, pose and
    outlier flags out, per problem; operations = one pass over the M
    landmarks (~300 flops each: transform, projection, Jacobian, normal
    equations) per LM iteration, plus the first linearization and the
    chi2 pass of each of the 4 rounds."""
    return bound(len(iters) * (m * (12 + 8 + 8) + m * 4 + 64),
                 sum(it + 2 * 4 for it in iters) * m * 300)


def phase_pnp_batched(dev, m: int, single9) -> dict:
    """K1 over B = 4 problems in one launch (the loop path's verify_top_k):
    pnp_problem at seeds 9-11, and seed 12 with 8 active slots (too few
    inliers: fails), each held against the plain version and bit for bit
    against a B = 1 launch on its own inputs; the seed-9 problem also
    against the main-path K1 launch above."""
    import torch

    from vio360_tpu_torch.solver import ba_cuda

    probs = [pnp_problem(dev, m, seed) for seed in (9, 10, 11)] + [pnp_problem(dev, m, 12, n_active=8)]
    bargs = (*(torch.stack([p[i] for p in probs]) for i in range(6)), *probs[0][6:])
    kb = ba_cuda._pnp_launch(*bargs)
    pb = ba_cuda._pnp_plain(*bargs)
    singles = [ba_cuda._pnp_launch(*p) for p in probs]
    torch.cuda.synchronize()
    for i, one in enumerate(singles):
        check(all(torch.equal(kb[j][i], one[j]) for j in range(7)),
              f"K1 batched: problem {i} differs from its B = 1 launch")
    check(all(torch.equal(kb[j][0], single9[j]) for j in range(7)),
          "K1 batched: problem 0 differs from the main-path launch")
    dt_ = float((kb[1] - pb[1]).abs().max())
    dr_ = float((kb[0] - pb[0]).abs().max())
    inl_k, inl_p = kb[4].tolist(), pb[4].tolist()
    log(f"[K1 lm_pnp B=4 M={m}] each problem equal to its B = 1 launch; |dt| {dt_:.3e} |dR| "
        f"{dr_:.3e}; inliers {inl_k} vs plain {inl_p}; LM iterations {kb[6].tolist()}")
    check(dt_ < 5e-3 and dr_ < 5e-4 and all(abs(a - b) <= 3 for a, b in zip(inl_k, inl_p)),
          "K1 batched disagrees with its plain version")
    check(min(inl_k[:3]) >= 25 and inl_k[3] < 10, "K1 batched: expected 3 successes and 1 failure")
    k_ms = device_ms(lambda: ba_cuda.pnp_solve(*bargs), "pnp_kernel", 20)
    w_ms = timed_ms(lambda: ba_cuda.pnp_solve(*bargs), 20)
    p_ms = timed_ms(lambda: ba_cuda._pnp_plain(*bargs), 2)
    rec = dict(b=4, max_abs_err=max(dt_, dr_), ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms,
               **pnp_bound(m, kb[6].tolist()))
    log(f"[K1 lm_pnp B=4 M={m}] kernel {k_ms:.4f} ms, wrapper {w_ms:.4f} ms vs plain {p_ms:.3f} ms; "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return rec


def phase_gather(dev, img0, img1, uv, valid):
    """K5 against its plain version at every (level, g) the matmul LK uses
    on 960x480 with N = 1024: g = p+3 = 24 (template), 34 (search at the
    top processed level), 28 (search below); edge rows included."""
    import torch

    from vio360_tpu_torch.ops import gather_cuda, lk_matmul

    levels = lk_matmul.level_images(img0, img1, 3)
    n = uv.shape[0]
    rec = None
    for lvl, (im_i, im_j, w_k) in enumerate(levels):
        h_k, wp = im_i.shape
        s = 1.0 / (1 << lvl)
        for g in (24, 34, 28):
            drift = (g - 21 - 1) // 2
            v0 = (torch.floor(uv[:, 1] * s - 10) - drift).to(torch.int32)
            v0[:64] = torch.linspace(-6, h_k + 4, 64, device=dev).to(torch.int32)  # edge rows
            u0 = torch.remainder((torch.floor(uv[:, 0] * s - 10) - drift).to(torch.int32), w_k)
            b = torch.div(u0, 128, rounding_mode="floor")
            img = im_j if g != 24 else im_i
            got = gather_cuda.gather_window_pairs(img, v0, b, g)
            ref = gather_cuda.gather_window_pairs_plain(img, v0, b, g)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"K5 disagrees at level {lvl}, g {g}")
            if lvl == 0 and g == 28:  # the largest call on the path: level-0 search patches
                k_ms = device_ms(lambda: gather_cuda.gather_window_pairs(img, v0, b, g),
                                 "gather_win_kernel", 50)
                w_ms = timed_ms(lambda: gather_cuda.gather_window_pairs(img, v0, b, g), 50)
                p_ms = timed_ms(lambda: gather_cuda.gather_window_pairs_plain(img, v0, b, g), 20)
                imgb = img.to(torch.bfloat16)
                rows, cols = gather_cuda.window_indices(h_k, wp, v0, b, g)
                ri, ci = rows[:, :, None], cols[:, None, :]
                lib_ms = timed_ms(lambda: imgb[ri, ci], 50)
                rec = dict(max_abs_err=0.0, ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms, library_ms=lib_ms,
                           **bound(h_k * wp * 4 + n * 8 + n * g * 256 * 2, n * g * 256))
                log(f"[K5 gather_win level 0 N={n} g={g} WP={wp}] kernel {k_ms:.4f} ms, wrapper "
                    f"{w_ms:.4f} ms vs plain {p_ms:.4f} ms, "
                    f"indexing call {lib_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        log(f"[K5 gather_win level {lvl} {h_k}x{wp}] equal to its plain version at g = 24, 34, 28")
    return rec


def phase_lk_matmul(dev):
    """The matmul-gather LK on the card against the same call on the CPU."""
    from vio360_tpu_torch.ops import lk_matmul

    img0, img1, uv, valid = lk_problem(dev)
    uc, sc, _ = lk_matmul.track(img0, img1, uv, valid)
    up, sp, _ = lk_matmul.track(img0.cpu(), img1.cpu(), uv.cpu(), valid.cpu())
    sc = sc.cpu()
    both = sc & sp
    d = float((uc.cpu() - up)[both].abs().max())
    ms = timed_ms(lambda: lk_matmul.track(img0, img1, uv, valid), 10)
    log(f"[lk_matmul 960x480 N=1024 4 levels] card {int(sc.sum())} vs CPU {int(sp.sum())} tracked; "
        f"max |duv| {d:.3e} px on {int(both.sum())} both-tracked; {ms:.3f} ms on the card")
    check(abs(int(sc.sum()) - int(sp.sum())) <= 0.01 * int(sp.sum()) and d < 1e-2,
          "lk_matmul on the card disagrees with the CPU")


def evaluate_ate(traj: Path, groundtruth: Path, align: str) -> dict:
    """ATE record of the port's evaluator (``tools/evaluate_ate.py``'s
    association rule and keys), computed in this process."""
    from vio360_tpu_torch.utils import metrics

    out = metrics.evaluate_tum(str(traj), str(groundtruth), align)
    check("error" not in out, f"ATE of {traj}: {out.get('error')}")
    return out


def _counters():
    from vio360_tpu_torch.ops import gather_cuda, lk_cuda
    from vio360_tpu_torch.solver import ba_cuda

    return (ba_cuda.LAUNCHES, lk_cuda.LAUNCHES, gather_cuda.LAUNCHES, ba_cuda.PNP_BATCHES)


def _run_cli(seq: Path, extra: list, dev):
    """The port's CLI on ``seq`` with every launch counter at 0 ->
    (launches, metrics rows, wall seconds); ``launches`` also holds K1's
    launches by batch size under ("lm_pnp", B)."""
    import torch

    from vio360_tpu_torch import cli

    (seq / "metrics.jsonl").unlink(missing_ok=True)  # the writer appends
    for c in _counters():
        c.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    rc = cli.main([str(seq), *extra, "--output", str(seq / "traj.tum"), "--metrics",
                   str(seq / "metrics.jsonl"), "--device", str(dev), "--quiet"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    *kernels, batches = _counters()
    launches = {k: v for c in kernels for k, v in c.items()}
    launches.update({("lm_pnp", b): n for b, n in batches.items()})
    check(rc == 0, f"CLI exited {rc}")
    rows = [json.loads(line) for line in (seq / "metrics.jsonl").read_text().splitlines()]
    return launches, rows, wall


def render_sequence(dev) -> Path:
    from vio360_tpu_torch import synthetic

    seq = ROOT / "build" / "smoke_seq11"
    shutil.rmtree(seq, ignore_errors=True)
    t0 = time.time()
    synthetic.make_dataset(str(seq), frames=40, width=960, height=480, seed=11, texture=True,
                           device=dev)
    log(f"[slice] rendered 40 frames 960x480 (seed 11, textured, with IMU) in {time.time() - t0:.1f}s")
    return seq


def phase_slice(dev, seq: Path):
    import numpy as np

    traj = seq / "traj.tum"
    launches, rows, wall = _run_cli(seq, ["--vo", "--no-loop", "--no-pose-graph"], dev)
    frames = [r for r in rows if "frame" in r]
    states = [r["state"] for r in frames]
    n_kf = sum(bool(r["keyframe"]) for r in frames)
    lm = [r["n_lm_alive"] for r in frames if "n_lm_alive" in r]
    p_est = np.loadtxt(traj, ndmin=2)[:, 1:4]  # TUM rows: t x y z qx qy qz qw
    ate = float(evaluate_ate(traj, seq / "groundtruth.tum", "sim3")["ate_rmse_sim3"])
    log(f"[slice] frames {len(frames)}, init at frame {states.index('initialized') if 'initialized' in states else -1}, "
        f"keyframes {n_kf}, landmarks {lm[-1] if lm else 0}, sim3 ATE {ate:.6f} m "
        f"(bound {ATE_BOUND:.6f}, JAX {JAX_ATE:.6f}), wall {1000 * wall / len(frames):.1f} ms/frame")
    log(f"[slice] launches {dict(launches)}")
    check("initialized" in states, "the slice never initialized")
    check(n_kf >= 3, f"only {n_kf} keyframes")
    for name in ("lk_pyr", "lm_pnp", "lm_ba_solve"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched by the main path")
    check(math.isfinite(ate) and ate <= ATE_BOUND, f"ATE {ate} above bound {ATE_BOUND}")
    check(np.isfinite(p_est).all() and p_est.shape == (40, 3), "bad trajectory")
    return launches


def phase_vio(dev, seq: Path):
    """The VIO slice through the CLI at --lk-backend matmul."""
    import numpy as np

    traj = seq / "traj.tum"
    launches, rows, wall = _run_cli(seq, ["--lk-backend", "matmul", "--no-loop", "--no-pose-graph"],
                                    dev)
    frames = [r for r in rows if "frame" in r]
    summary = next(r for r in rows if r.get("event") == "stage_summary")
    states = [r["state"] for r in frames]
    n_kf = sum(bool(r["keyframe"]) for r in frames)
    init = states.index("initialized") if "initialized" in states else -1
    imu_init = next((r["frame"] for r in frames if r.get("imu_initialized")), -1)
    p_est = np.loadtxt(traj, ndmin=2)[:, 1:4]
    ev = evaluate_ate(traj, seq / "groundtruth.tum", "se3")
    ate, scale_err = float(ev["ate_rmse_se3"]), float(ev["scale_error"])
    steady = [r["wall_time"] for r in frames]
    log(f"[vio] frames {len(frames)}, init at frame {init}, IMU init at frame {imu_init}, "
        f"keyframes {n_kf}, SE(3) ATE {ate:.6f} m (bound {VIO_ATE_BOUND:.6f}, JAX "
        f"{JAX_VIO_ATE_SE3:.6f}), scale error {scale_err:.5f} (bound {VIO_SCALE_BOUND:.5f}, JAX "
        f"{JAX_VIO_SCALE_ERR:.5f}), wall {1000 * wall / len(frames):.1f} ms/frame, steady "
        f"{1000 * (steady[-1] - steady[init]) / max(len(frames) - 1 - init, 1):.1f} ms/frame after init")
    log("[vio] stage means (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(summary.items())
                                               if k not in ("event", "wall_time")))
    log(f"[vio] launches {dict(launches)}")
    check(init >= 0, "the VIO slice never initialized")
    check(imu_init >= 0, "the VIO slice never initialized the IMU")
    check(n_kf >= 3, f"only {n_kf} keyframes")
    for name in ("gather_win", "lm_pnp", "lm_ba_solve"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched by the VIO path")
    check(math.isfinite(ate) and ate <= VIO_ATE_BOUND, f"SE(3) ATE {ate} above {VIO_ATE_BOUND}")
    check(scale_err <= VIO_SCALE_BOUND, f"scale error {scale_err} above {VIO_SCALE_BOUND}")
    check(np.isfinite(p_est).all() and p_est.shape == (40, 3), "bad trajectory")
    return launches


def _frames_ate(traj: Path, seq: Path, first: int) -> float:
    """sim3 ATE of the trajectory's frames from ``first`` on (the port's
    evaluator on truncated copies of both files)."""
    cut = seq / "cut"
    cut.mkdir(exist_ok=True)
    for src in (traj, seq / "groundtruth.tum"):
        rows = src.read_text().splitlines()
        (cut / src.name).write_text("\n".join(rows[first:]) + "\n")
    return float(evaluate_ate(cut / traj.name, cut / "groundtruth.tum", "sim3")["ate_rmse_sim3"])


def phase_loop(dev):
    """The loop slice: the 300-frame three-lap revisit sequence through the
    CLI as VO at the defaults (loop closure and pose graph on)."""
    import numpy as np

    from vio360_tpu_torch import synthetic

    seq = ROOT / "build" / "smoke_loop41"
    shutil.rmtree(seq, ignore_errors=True)
    t0 = time.time()
    synthetic.make_dataset(str(seq), frames=300, width=960, height=480, seed=41, texture=True,
                           revisit=True, laps=3, pixel_noise=0.05, device=dev)
    log(f"[loop] rendered 300 frames 960x480 (seed 41, textured, 3 laps, pixel noise 0.05) in "
        f"{time.time() - t0:.1f}s")
    traj = seq / "traj.tum"
    launches, rows, wall = _run_cli(seq, ["--vo"], dev)
    frames = [r for r in rows if "frame" in r]
    states = [r["state"] for r in frames]
    graph = next(r for r in rows if r.get("event") == "pose_graph")
    summary = next(r for r in rows if r.get("event") == "stage_summary")
    loops = [(r["frame"], r["loop_closed_to"]) for r in frames if "loop_closed_to" in r]
    p_est = np.loadtxt(traj, ndmin=2)[:, 1:4]
    ate = float(evaluate_ate(traj, seq / "groundtruth.tum", "sim3")["ate_rmse_sim3"])
    b4 = launches.get(("lm_pnp", 4), 0)
    log(f"[loop] init at frame {states.index('initialized') if 'initialized' in states else -1}, "
        f"keyframes {sum(bool(r['keyframe']) for r in frames)}, verified loops {len(loops)} "
        f"(first {loops[:3]}), pose graph {graph}, K1 launches with B = 4: {b4}")
    log(f"[loop] sim3 ATE {ate:.6f} m (bound {LOOP_ATE_BOUND:.6f}, JAX {JAX_LOOP_ATE:.6f}), wall "
        f"{1000 * wall / len(frames):.1f} ms/frame; stage means (ms): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(summary.items()) if k not in ("event", "wall_time")))
    log(f"[loop] launches {launches}")
    check("initialized" in states, "the loop slice never initialized")
    check(graph["edges"] > 0 and graph["nodes"] > 0, "no eviction edges recorded")
    check(math.isfinite(graph["vis_w_t_median"]) and graph["vis_w_t_median"] > 0
          and graph["vis_w_t_median"] != 20.0, "eviction edges without covariance weights")
    check(len(loops) >= 1 and graph["loop_edges"] >= 1, "no verified loop closed")
    check(graph["sim3_nodes"] > 0, "the Sim(3) pose graph did not run at export")
    check(b4 > 0, "loop verification never launched K1 with B = 4")
    for name in ("lk_pyr", "lm_pnp", "lm_ba_solve"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched by the loop path")
    check(math.isfinite(ate) and ate <= LOOP_ATE_BOUND, f"ATE {ate} above bound {LOOP_ATE_BOUND}")
    check(np.isfinite(p_est).all() and p_est.shape == (300, 3), "bad trajectory")
    ref = dict(traj=traj.read_text(), loops=loops, graph=graph, frames=frames, wall=wall)
    # for information (no gate): the same run without loop closure
    _, _, wall_off = _run_cli(seq, ["--vo", "--no-loop"], dev)
    ate_off = float(evaluate_ate(traj, seq / "groundtruth.tum", "sim3")["ate_rmse_sim3"])
    log(f"[loop] without loop closure: sim3 ATE {ate_off:.6f} m (JAX {JAX_NOLOOP_ATE:.6f}), wall "
        f"{1000 * wall_off / len(frames):.1f} ms/frame")
    return launches, seq, ref


def phase_resume(dev, seq: Path, ref: dict):
    """Phase 7's run cut in two: ``--max-frames 150 --checkpoint``, then
    ``--resume`` under ``--profile``; the result must be phase 7's, bit for bit."""
    ck, prof_dir = seq / "ck.npz", seq / "profile"
    ck.unlink(missing_ok=True)
    shutil.rmtree(prof_dir, ignore_errors=True)
    first, rows1, wall1 = _run_cli(seq, ["--vo", "--max-frames", "150", "--checkpoint", str(ck)], dev)
    frames1 = [r for r in rows1 if "frame" in r]
    check(ck.is_file() and len(frames1) == 150, "the first half wrote no checkpoint")
    second, rows2, wall2 = _run_cli(seq, ["--vo", "--resume", str(ck), "--profile", str(prof_dir)],
                                    dev)
    frames2 = [r for r in rows2 if "frame" in r]
    graph = next(r for r in rows2 if r.get("event") == "pose_graph")
    loops = [(r["frame"], r["loop_closed_to"]) for r in frames1 + frames2 if "loop_closed_to" in r]
    same_traj = (seq / "traj.tum").read_text() == ref["traj"]
    keys = ("frame", "state", "keyframe", "tracked", "inliers", "loop_closed_to")
    parted = next((a["frame"] for a, b in zip(ref["frames"], frames1 + frames2)
                   if any(a.get(k) != b.get(k) for k in keys)), None)
    trace = (prof_dir / "trace.json").read_text() if (prof_dir / "trace.json").is_file() else ""
    named = {k: k in trace for k in ("lk_kernel", "pnp_kernel", "ba_kernel")}
    log(f"[resume] frames {len(frames1)} + {len(frames2)} (resume wall {wall2:.1f}s, "
        f"{1000 * wall2 / max(len(frames2), 1):.1f} ms/frame under the profiler; first half "
        f"{1000 * wall1 / len(frames1):.1f} ms/frame; checkpoint {ck.stat().st_size / 1e6:.1f} MB); "
        f"trajectory equal to phase 7's: {same_traj}; first frame whose record differs: {parted}; "
        f"verified loops {len(loops)} (phase 7 {len(ref['loops'])}); pose graph {graph}; "
        f"trace {len(trace) / 1e6:.1f} MB names {named}")
    log(f"[resume] launches {first} + {second}")
    check(frames2 and frames2[0]["frame"] == 150 and len(frames1) + len(frames2) == 300,
          "the resumed run did not continue at frame 150")
    check(parted is None, f"the resumed run parts from phase 7's at frame {parted}")
    check(loops == ref["loops"], "the resumed run's verified loops differ from phase 7's")
    check(all(graph[k] == ref["graph"][k] for k in ("nodes", "edges", "loop_edges", "sim3_nodes")),
          "the resumed run's pose graph differs from phase 7's")
    check(same_traj, "the resumed trajectory differs from phase 7's")
    check(all(named.values()), f"the profile does not name every kernel: {named}")
    for name in ("lk_pyr", "lm_pnp", "lm_ba_solve"):
        check(second.get(name, 0) > 0, f"kernel {name} was not launched by the resumed run")
    return {k: first.get(k, 0) + second.get(k, 0) for k in set(first) | set(second)}


def phase_vio_defaults(dev):
    """VIO at the defaults: the 100-frame one-lap revisit sequence with its
    IMU stream through the CLI (loop closure, pose graph with IMU edges,
    per-feature LK)."""
    import numpy as np

    from vio360_tpu_torch import synthetic

    seq = ROOT / "build" / "smoke_vio41"
    shutil.rmtree(seq, ignore_errors=True)
    synthetic.make_dataset(str(seq), frames=100, width=960, height=480, seed=41, texture=True,
                           revisit=True, laps=1, pixel_noise=0.05, device=dev)
    traj = seq / "traj.tum"
    launches, rows, wall = _run_cli(seq, [], dev)
    frames = [r for r in rows if "frame" in r]
    states = [r["state"] for r in frames]
    graph = next(r for r in rows if r.get("event") == "pose_graph")
    summary = next(r for r in rows if r.get("event") == "stage_summary")
    imu_init = next((r["frame"] for r in frames if r.get("imu_initialized")), -1)
    loops = [r["frame"] for r in frames if "loop_closed_to" in r]
    after = [f for f in loops if 0 <= imu_init < f]
    p_est = np.loadtxt(traj, ndmin=2)[:, 1:4]
    ev = evaluate_ate(traj, seq / "groundtruth.tum", "se3")
    ate, scale_err = float(ev["ate_rmse_se3"]), float(ev["scale_error"])
    log(f"[vio-defaults] init at frame {states.index('initialized') if 'initialized' in states else -1}, "
        f"IMU init at frame {imu_init} (JAX {JAX_DVIO_IMU_INIT_FRAME}), keyframes "
        f"{sum(bool(r['keyframe']) for r in frames)}, verified loops {len(loops)} (JAX "
        f"{JAX_DVIO_LOOPS}), first after IMU init at frame {after[0] if after else -1} (JAX "
        f"{JAX_DVIO_FIRST_LOOP}); pose graph {graph}")
    log(f"[vio-defaults] SE(3) ATE {ate:.6f} m (bound {DVIO_ATE_BOUND:.6f}, JAX "
        f"{JAX_DVIO_ATE_SE3:.6f}), scale error {scale_err:.5f} (bound {DVIO_SCALE_BOUND:.5f}, JAX "
        f"{JAX_DVIO_SCALE_ERR:.5f}), wall {1000 * wall / len(frames):.1f} ms/frame; stage means "
        "(ms): " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(summary.items())
                             if k not in ("event", "wall_time")))
    log(f"[vio-defaults] launches {launches}")
    check(imu_init >= 0, "VIO at the defaults never initialized the IMU")
    check(bool(after), "no verified loop after IMU init")
    for name in ("lk_pyr", "lm_pnp", "lm_ba_solve"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched by VIO at the defaults")
    check(math.isfinite(ate) and ate <= DVIO_ATE_BOUND, f"SE(3) ATE {ate} above {DVIO_ATE_BOUND}")
    check(scale_err <= DVIO_SCALE_BOUND, f"scale error {scale_err} above {DVIO_SCALE_BOUND}")
    check(np.isfinite(p_est).all() and p_est.shape == (100, 3), "bad trajectory")
    return launches


def phase_reloc(dev):
    """Relocalization: a 90-frame sequence blacked out for frames 45-54
    through the CLI as VO with configs/synthetic_480.yaml (480x240: at
    960x480 and the defaults the JAX package never relocalizes on it)."""
    import numpy as np

    from vio360_tpu_torch import synthetic

    seq = ROOT / "build" / "smoke_reloc51"
    shutil.rmtree(seq, ignore_errors=True)
    synthetic.make_dataset(str(seq), frames=90, width=480, height=240, seed=51, texture=True,
                           pixel_noise=0.02, blackout=(45, 55), device=dev)
    traj = seq / "traj.tum"
    launches, rows, wall = _run_cli(
        seq, ["--vo", "--config", str(ROOT / "configs" / "synthetic_480.yaml")], dev)
    frames = [r for r in rows if "frame" in r]
    states = [r["state"] for r in frames]
    summary = next(r for r in rows if r.get("event") == "stage_summary")
    lost = [r["frame"] for r in frames if r["state"] == "tracking_lost"]
    reloc = next((r for r in frames if r["state"] == "relocalized"), None)
    f_rel = reloc["frame"] if reloc else -1
    after = states[f_rel + 1:] if reloc else []
    ate = _frames_ate(traj, seq, f_rel + 2) if reloc else math.inf
    log(f"[reloc] lost frames {lost[:3]}..{lost[-3:]} ({len(lost)}), relocalized at frame {f_rel} "
        f"(JAX {JAX_RELOC_FRAME}) against frame {reloc.get('reloc_to') if reloc else None}, "
        f"{after.count('tracking')}/{len(after)} frames tracking after it; sim3 ATE after it "
        f"{ate:.6f} m (bound {RELOC_ATE_BOUND:.6f}, JAX {JAX_RELOC_ATE:.6f}), wall "
        f"{1000 * wall / len(frames):.1f} ms/frame, reloc stage {summary.get('reloc', 0.0):.2f} ms")
    log(f"[reloc] launches {launches}")
    check(bool(lost) and 45 <= min(lost) < 55, "the blackout did not lose tracking")
    check(reloc is not None and abs(f_rel - JAX_RELOC_FRAME) <= 2,
          f"relocalized at frame {f_rel}, JAX at {JAX_RELOC_FRAME}")
    check(all(s == "tracking" for s in after), "tracking did not hold after the relocalization")
    check(math.isfinite(ate) and ate <= RELOC_ATE_BOUND, f"ATE {ate} above bound {RELOC_ATE_BOUND}")
    check(launches.get(("lm_pnp", 4), 0) > 0, "relocalization never launched K1 with B = 4")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs only on a card", file=sys.stderr)
        return 1
    if not (ROOT / "vio360_tpu_torch").is_dir():
        print(f"error: {ROOT} holds no vio360_tpu_torch package", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from vio360_tpu_torch import device as device_mod

    device_mod.pin_fp32()
    dev = torch.device("cuda:0")
    walls = {}

    def timed(label, fn, *args):
        t0 = time.time()
        out = fn(*args)
        walls[label] = round(time.time() - t0, 1)
        return out

    name, count = timed("1 device", phase_device)
    timed("2 build", phase_build)
    rec = timed("3 kernels", phase_kernels, dev)
    timed("4 lk_matmul", phase_lk_matmul, dev)
    seq = render_sequence(dev)
    vo = timed("5 vo", phase_slice, dev, seq)
    vio = timed("6 vio", phase_vio, dev, seq)
    loop, loop_seq, loop_ref = timed("7 loop", phase_loop, dev)
    reloc = timed("8 reloc", phase_reloc, dev)
    resume = timed("9 resume", phase_resume, dev, loop_seq, loop_ref)
    dvio = timed("10 vio-defaults", phase_vio_defaults, dev)
    log(f"[phases] wall s: {walls}")
    sources = {
        "lk_pyr": ("vio360_tpu_torch/csrc/lk_pyr.cu", "vio360_tpu/ops/lk_pallas.py:64"),
        "lm_pnp": ("vio360_tpu_torch/csrc/lm_solve.cu", "vio360_tpu/solver/ba_pallas.py:777"),
        "lm_ba_solve": ("vio360_tpu_torch/csrc/lm_solve.cu", "vio360_tpu/solver/ba_pallas.py:667"),
        "lm_ba_iteration": ("vio360_tpu_torch/csrc/lm_solve.cu", "vio360_tpu/solver/ba_pallas.py:455"),
        "gather_win": ("vio360_tpu_torch/csrc/gather_win.cu", "vio360_tpu/ops/gather_pallas.py:46"),
    }
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": int(sum(run.get(k, 0) for run in (vo, vio, loop, reloc, resume, dvio))),
         **rec[k],
         **({"note": "tests only: on no main path"} if k == "lm_ba_iteration" else {})}
        for k, (src, rep) in sources.items()
    ]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
