"""Essential-matrix estimation on unit-sphere bearing vectors.

Counterpart of ``vio360_tpu/geometry/essential.py``. Every function
takes leading hypothesis-batch dims directly (the JAX module ``vmap``s).
"""

from __future__ import annotations

import torch


def essential_constraint_rows(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] x2 -> [..., N, 9] rows of the epipolar constraint (row-major E)."""
    return (b2[..., :, None] * b1[..., None, :]).flatten(-2)


def _null_vector(a: torch.Tensor) -> torch.Tensor:
    """Right singular vector of the smallest singular value of [..., R, 9].
    The full V is needed only when R < 9 (otherwise the reduced SVD
    already holds all nine right singular vectors)."""
    _, _, vt = torch.linalg.svd(a, full_matrices=a.shape[-2] < a.shape[-1])
    return vt[..., -1, :]


def solve_eight_point(b1, b2, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares E from N >= 8 correspondences -> [..., 3, 3]; optional
    0/1 row weights give a fixed-shape all-inlier refit."""
    a = essential_constraint_rows(b1, b2)
    if weights is not None:
        a = a * weights[..., None]
    e = _null_vector(a).reshape(*a.shape[:-2], 3, 3)
    return enforce_rank2(e)


def enforce_rank2(e: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold: singular values -> (s, s, 0)."""
    u, s, vt = torch.linalg.svd(e)
    sigma = 0.5 * (s[..., 0] + s[..., 1])
    scale = torch.stack([sigma, sigma, torch.zeros_like(sigma)], -1)
    return (u * scale[..., None, :]) @ vt


def epipolar_errors(e: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """|b2^T E b1| for E [..., 3, 3] against [N, 3] bearings -> [..., N]."""
    return torch.abs((b2 * (b1 @ e.transpose(-1, -2))).sum(-1))


def decompose_essential(e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E -> (Rs [4, 3, 3], ts [4, 3]): (R1, +t), (R1, -t), (R2, +t), (R2, -t)."""
    u, _, vt = torch.linalg.svd(e)
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=e.dtype, device=e.device)
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u[:, 2]
    d1 = torch.linalg.det(r1)
    t = torch.where(d1 < 0, -t, t)
    r1 = torch.where(d1 < 0, -r1, r1)
    r2 = torch.where(torch.linalg.det(r2) < 0, -r2, r2)
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([r1, r1, r2, r2]), torch.stack([t, -t, t, -t])
