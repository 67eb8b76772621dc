"""Equirectangular (ERP) camera model on torch tensors.

Counterpart of ``vio360_tpu/geometry/camera.py``: pixel arrays are
``[..., 2]`` (u, v), points and bearings ``[..., 3]``; camera frame
X-right, Y-down, Z-forward.
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi


def fmod_positive(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.mod`` for floats and a positive modulus: the truncated
    remainder shifted into [0, m) (the same arithmetic as JAX, so wrapped
    coordinates agree bit for bit)."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def pixel_to_bearing(uv: torch.Tensor, width: float, height: float) -> torch.Tensor:
    """[..., 2] pixels -> [..., 3] unit bearings."""
    lon = (uv[..., 0] / width - 0.5) * _TWO_PI
    lat = -(uv[..., 1] / height - 0.5) * math.pi
    cos_lat = torch.cos(lat)
    b = torch.stack([cos_lat * torch.sin(lon), -torch.sin(lat), cos_lat * torch.cos(lon)], -1)
    return b / torch.linalg.norm(b, dim=-1, keepdim=True)


def bearing_to_pixel(b: torch.Tensor, width: float, height: float) -> torch.Tensor:
    """[..., 3] bearings (any norm) -> [..., 2] pixels."""
    norm = torch.linalg.norm(b, dim=-1)
    theta = torch.atan2(b[..., 0], b[..., 2])
    phi = -torch.arcsin(torch.clamp(b[..., 1] / torch.clamp(norm, min=1e-12), -1.0, 1.0))
    return torch.stack([width * (0.5 + theta / _TWO_PI), height * (0.5 - phi / math.pi)], -1)


def project(p_c: torch.Tensor, width: float, height: float) -> torch.Tensor:
    return bearing_to_pixel(p_c, width, height)


def wrap_residual_u(du: torch.Tensor, width: float) -> torch.Tensor:
    """Wrap a horizontal pixel residual into [-W/2, W/2]."""
    return du - width * torch.round(du / width)


def reprojection_residual(obs_uv, p_c, width, height) -> torch.Tensor:
    """obs - project(p_c) with horizontal wrap; [..., 2]."""
    d = obs_uv - project(p_c, width, height)
    return torch.stack([wrap_residual_u(d[..., 0], width), d[..., 1]], -1)


def is_in_polar_region(uv: torch.Tensor, height: float, threshold: float) -> torch.Tensor:
    v_ratio = uv[..., 1] / height
    return (v_ratio < threshold) | (v_ratio > 1.0 - threshold)


def is_near_boundary(uv: torch.Tensor, width: float, height: float, margin: float) -> torch.Tensor:
    u, v = uv[..., 0], uv[..., 1]
    return (u < margin) | (u > width - margin) | (v < margin) | (v > height - margin)


def polar_mask(width: int, height: int, ratio: float, device=None) -> torch.Tensor:
    """[H, W] bool mask, False in the excluded polar rows."""
    rows = torch.arange(height, device=device)
    row_ok = (rows >= int(height * ratio)) & (rows < int(height * (1.0 - ratio)))
    return row_ok[:, None].expand(height, width)


def projection_jacobian(p_c: torch.Tensor, width: float, height: float) -> torch.Tensor:
    """Analytic d(proj uv)/d(p_c): [..., 2, 3]."""
    x, y, z = p_c.unbind(-1)
    xz_sq = x * x + z * z
    l_sq = x * x + y * y + z * z
    xz = torch.sqrt(xz_sq)
    safe_xz_sq = torch.clamp(xz_sq, min=1e-12)
    safe_l_sq = torch.clamp(l_sq, min=1e-12)
    safe_xz = torch.clamp(xz, min=1e-12)
    cu = width / _TWO_PI
    cv = height / math.pi
    row_u = torch.stack([cu * z / safe_xz_sq, torch.zeros_like(x), -cu * x / safe_xz_sq], -1)
    row_v = torch.stack(
        [
            -cv * x * y / (safe_l_sq * safe_xz),
            cv * xz / safe_l_sq,
            -cv * y * z / (safe_l_sq * safe_xz),
        ],
        -1,
    )
    return torch.stack([row_u, row_v], -2)
