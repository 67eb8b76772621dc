"""Bilinear image sampling with ERP horizontal wrap.

Counterpart of ``vio360_tpu/ops/sampling.py``: u wraps (mod W), v is
clamped (v0 clamped first, v1 = clamp(v0 + 1)), pixel centres at
integer coordinates.
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample img [H, W] at uv [..., 2] -> [...]."""
    h, w = img.shape
    u, v = uv[..., 0], uv[..., 1]
    u0f, v0f = torch.floor(u), torch.floor(v)
    au, av = u - u0f, v - v0f
    u0 = torch.remainder(u0f.to(torch.int64), w)
    u1 = torch.remainder(u0 + 1, w)
    v0 = torch.clamp(v0f.to(torch.int64), 0, h - 1)
    v1 = torch.clamp(v0 + 1, 0, h - 1)
    flat = img.reshape(-1)
    i00, i01 = flat[v0 * w + u0], flat[v0 * w + u1]
    i10, i11 = flat[v1 * w + u0], flat[v1 * w + u1]
    top = i00 * (1.0 - au) + i01 * au
    bot = i10 * (1.0 - au) + i11 * au
    return top * (1.0 - av) + bot * av


def patch_offsets(half: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[(2h+1)^2, 2] (du, dv) offsets, row-major over (dv, du)."""
    r = torch.arange(-half, half + 1, dtype=dtype, device=device)
    dv, du = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([du.reshape(-1), dv.reshape(-1)], -1)


def patch_coords(center_uv: torch.Tensor, half: int) -> torch.Tensor:
    """Centres [..., 2] -> sample grid [..., (2h+1)^2, 2]."""
    return center_uv[..., None, :] + patch_offsets(half, center_uv.dtype, center_uv.device)
