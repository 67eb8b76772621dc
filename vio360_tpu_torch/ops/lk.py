"""Batched pyramidal Lucas-Kanade optical flow (backend dispatcher).

Counterpart of ``vio360_tpu/ops/lk.py::track``. ``backend="matmul"``
runs the matmul-gather LK (``ops/lk_matmul.py``, kernel K5) with the
reference's synchronized ladder of ``min(iters, 8)`` steps; ``auto``,
``pallas`` and ``xla`` run the per-feature LK: kernel K4 on CUDA tensors,
its plain twin of ``track_xla`` on CPU tensors (``ops/lk_cuda.py``).
"""

from __future__ import annotations

from . import lk_matmul
from .lk_cuda import track_plain
from .lk_cuda import track as track_per_feature

__all__ = ["track", "track_plain"]

BACKENDS = ("auto", "xla", "pallas", "matmul")


def track(img_prev, img_next, uv_prev, valid_in, uv_guess=None, num_levels=3, half_win=10,
          iters=30, eps=0.01, backend: str = "auto"):
    """Pyramidal LK for all features: (uv [N, 2] with u in [0, W), status [N], err [N])."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown LK backend {backend!r} (one of {BACKENDS})")
    if backend == "matmul":
        return lk_matmul.track(img_prev, img_next, uv_prev, valid_in, uv_guess,
                               num_levels=num_levels, half_win=half_win, iters=min(iters, 8),
                               eps=eps)
    return track_per_feature(img_prev, img_next, uv_prev, valid_in, uv_guess, num_levels,
                             half_win, iters, eps)
