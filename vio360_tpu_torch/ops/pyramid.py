"""Gaussian image pyramid and Scharr gradients for pyramidal LK.

Counterpart of ``vio360_tpu/ops/pyramid.py``: 5-tap binomial blur
[1 4 6 4 1]/16 then 2x decimation; horizontal wrap (ERP seam), vertical
edge clamp. Written as sliced adds, not ``conv2d``, so cuDNN's TF32
default never applies and the sums round like the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _taps(shifted) -> torch.Tensor:
    """sum_i K5[i] * shifted(i), added left to right."""
    acc = _K5[0] * shifted(0)
    for i in range(1, 5):
        acc += _K5[i] * shifted(i)
    return acc


def _blur_h(img: torch.Tensor) -> torch.Tensor:
    pad = torch.cat([img[..., :, -2:], img, img[..., :, :2]], -1)
    w = img.shape[-1]
    return _taps(lambda i: pad[..., :, i:i + w])


def _blur_v(img: torch.Tensor) -> torch.Tensor:
    pad = torch.cat([img[..., :1, :], img[..., :1, :], img, img[..., -1:, :], img[..., -1:, :]], -2)
    h = img.shape[-2]
    return _taps(lambda i: pad[..., i:i + h, :])


def pyr_down(img: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """One pyramid level of [..., H, W]: blur then decimate by 2, into
    ``out`` when given."""
    down = _blur_v(_blur_h(img))[..., ::2, ::2]
    return down.contiguous() if out is None else out.copy_(down)


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


# Banded-operator form, used by the matmul-gather LK (ops/lk_matmul.py):
# each level is L @ img @ R with constant numpy f32 operators whose
# entries are dyadic rationals (exact).


def blur_decimate_matrix(n: int, wrap: bool) -> np.ndarray:
    """(ceil(n/2), n) operator: 5-tap binomial blur then 2x decimation;
    ``wrap`` = ERP-seam wraparound (horizontal), else edge clamp."""
    m = np.zeros((n, n))
    for t in range(-2, 3):
        for i in range(n):
            j = (i + t) % n if wrap else min(max(i + t, 0), n - 1)
            m[i, j] += _K5[t + 2]
    return m[::2].astype(np.float32)


def wrap_pad_matrix(n_out: int, n: int) -> np.ndarray:
    """(n_out, n) selection: row r reads src (r mod n), the append-only
    horizontal wrap padding to a 128-aligned width."""
    m = np.zeros((n_out, n))
    m[np.arange(n_out), np.arange(n_out) % n] = 1.0
    return m.astype(np.float32)
