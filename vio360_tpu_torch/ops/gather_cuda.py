"""Window-pair gather of the matmul-gather LK: CUDA kernel K5 + its plain twin.

Counterpart of ``vio360_tpu/ops/gather_pallas.py::gather_window_pairs``
(stages 1-2 of ``lk_matmul._gather_int_patches``)::

    out[f, r, c] = bf16(img_pad)[clip(v0[f] + r, 0, H - 1), b[f] * 128 + c]

for an f32 image [H, WP] wrap-padded to whole 128-column blocks, giving
[N, g, 256] bf16. ``gather_window_pairs`` launches ``csrc/gather_win.cu``
for CUDA tensors and runs ``gather_window_pairs_plain`` (advanced
indexing) for CPU tensors. Both clamp ``b`` to [0, WP/128 - 2], so that
block ``b + 1`` exists and no read leaves the image.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .. import cuda_build
from ..device import check_kernel_device

#: kernel launches by name ("gather_win")
LAUNCHES: collections.Counter = collections.Counter()

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"gather_win": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP]}


def window_indices(h: int, wp: int, v0: torch.Tensor, b: torch.Tensor, g: int):
    """(rows [N, g], cols [N, 256]) int64 source indices of every output element."""
    rows = torch.clamp(v0.to(torch.int64)[:, None] + torch.arange(g, device=v0.device), 0, h - 1)
    blk = torch.clamp(b.to(torch.int64), 0, wp // 128 - 2)
    cols = blk[:, None] * 128 + torch.arange(256, device=b.device)
    return rows, cols


def gather_window_pairs_plain(img_pad: torch.Tensor, v0: torch.Tensor, b: torch.Tensor,
                              g: int) -> torch.Tensor:
    """Twin of K5 by advanced indexing."""
    h, wp = img_pad.shape
    rows, cols = window_indices(h, wp, v0, b, g)
    return img_pad.to(torch.bfloat16)[rows[:, :, None], cols[:, None, :]]


def gather_window_pairs(img_pad: torch.Tensor, v0: torch.Tensor, b: torch.Tensor,
                        g: int) -> torch.Tensor:
    """K5 on CUDA tensors, ``gather_window_pairs_plain`` on CPU tensors."""
    if not check_kernel_device(img_pad, "gather_window_pairs"):
        return gather_window_pairs_plain(img_pad, v0, b, g)
    dev = img_pad.device
    if img_pad.dim() != 2 or img_pad.dtype != torch.float32:
        raise ValueError("gather_win: img_pad must be f32 [H, WP]")
    h, wp = img_pad.shape
    n = v0.shape[0]
    if wp % 128 or wp < 256 or g < 1:
        raise ValueError(f"gather_win: WP {wp} must be a multiple of 128 (>= 256), g {g} >= 1")
    if v0.shape != (n,) or b.shape != (n,) or v0.device != dev or b.device != dev:
        raise ValueError("gather_win: v0 and b must be [N] on the image's device")
    img = img_pad.contiguous()
    if img.data_ptr() % 16:  # the kernel reads float4
        img = img.clone()
    v0i = v0.to(torch.int32).contiguous()
    bi = b.to(torch.int32).contiguous()
    out = torch.empty(n, g, 256, dtype=torch.bfloat16, device=dev)
    lib = cuda_build.load("gather_win", _SIGS)
    ptr = cuda_build.ptr
    rc = lib.gather_win(ptr(img), ptr(v0i), ptr(bi), ptr(out), n, g, h, wp,
                        cuda_build.stream_ptr(dev))
    cuda_build.check(rc, "gather_win launch")
    LAUNCHES["gather_win"] += 1
    return out
