"""Gaussian image pyramid and Scharr gradients for pyramidal LK.

Counterpart of ``vio360_tpu/ops/pyramid.py``: 5-tap binomial blur
[1 4 6 4 1]/16 then 2x decimation; horizontal wrap (ERP seam), vertical
edge clamp. Written as sliced adds, not ``conv2d``, so cuDNN's TF32
default never applies and the sums round like the reference's.
"""

from __future__ import annotations

import torch

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _blur_h(img: torch.Tensor) -> torch.Tensor:
    pad = torch.cat([img[:, -2:], img, img[:, :2]], 1)
    w = img.shape[1]
    return sum(_K5[i] * pad[:, i:i + w] for i in range(5))


def _blur_v(img: torch.Tensor) -> torch.Tensor:
    pad = torch.cat([img[:1], img[:1], img, img[-1:], img[-1:]], 0)
    h = img.shape[0]
    return sum(_K5[i] * pad[i:i + h] for i in range(5))


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One pyramid level: blur then decimate by 2."""
    return _blur_v(_blur_h(img))[::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, num_levels: int) -> list[torch.Tensor]:
    """[H, W] -> num_levels + 1 images (level 0 = original)."""
    levels = [img]
    for _ in range(num_levels):
        levels.append(pyr_down(levels[-1]))
    return levels


def scharr_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scharr 3x3 x/y gradients (smooth [3 10 3]/16, diff 0.5*[-1 0 1]),
    wrap in u, clamp in v."""
    p = torch.cat([img[:, -1:], img, img[:, :1]], 1)
    p = torch.cat([p[:1], p, p[-1:]], 0)
    s0, s1, s2 = 3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0
    sv = s0 * p[0:-2] + s1 * p[1:-1] + s2 * p[2:]
    ix = 0.5 * (sv[:, 2:] - sv[:, 0:-2])
    sh = s0 * p[:, 0:-2] + s1 * p[:, 1:-1] + s2 * p[:, 2:]
    iy = 0.5 * (sh[2:] - sh[0:-2])
    return ix.contiguous(), iy.contiguous()
