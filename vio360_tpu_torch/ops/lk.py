"""Batched pyramidal Lucas-Kanade optical flow (dispatcher).

Counterpart of ``vio360_tpu/ops/lk.py``. The JAX dispatcher chose
between an einsum formulation (a TPU-only way around slow gathers), the
Pallas kernel and the XLA twin; the port has one LK: kernel K4 on CUDA
tensors, its plain twin of ``track_xla`` on CPU tensors
(``ops/lk_cuda.py``).
"""

from __future__ import annotations

from .lk_cuda import track, track_plain

__all__ = ["track", "track_plain"]
