"""Small dense linear algebra for the LM solvers.

Counterpart of ``vio360_tpu/solver/linsolve.py``: unpivoted Gauss-Jordan
(valid for the damped SPD systems LM produces) and closed-form 3x3
inverses, kept as the same arithmetic so the port's plain solvers
round like the reference's.
"""

from __future__ import annotations

import torch


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a @ x = b`` ([n, n], [n]) by unpivoted Gauss-Jordan."""
    n = a.shape[0]
    aug = torch.cat([a, b[:, None]], 1)
    eye = torch.eye(n, dtype=aug.dtype, device=aug.device)
    for i in range(n):
        piv = aug[i] / aug[i, i]
        aug = aug - ((1.0 - eye[i]) * aug[:, i])[:, None] * piv[None, :]
        aug[i] = piv
    return aug[:, n]


def _cofactors(a, ix):
    """Adjugate entries and determinant of 3x3 matrices; ``ix(i, j)``
    reads entry (i, j) of the batch."""
    c = [[None] * 3 for _ in range(3)]
    c[0][0] = ix(1, 1) * ix(2, 2) - ix(1, 2) * ix(2, 1)
    c[0][1] = ix(0, 2) * ix(2, 1) - ix(0, 1) * ix(2, 2)
    c[0][2] = ix(0, 1) * ix(1, 2) - ix(0, 2) * ix(1, 1)
    c[1][0] = ix(1, 2) * ix(2, 0) - ix(1, 0) * ix(2, 2)
    c[1][1] = ix(0, 0) * ix(2, 2) - ix(0, 2) * ix(2, 0)
    c[1][2] = ix(0, 2) * ix(1, 0) - ix(0, 0) * ix(1, 2)
    c[2][0] = ix(1, 0) * ix(2, 1) - ix(1, 1) * ix(2, 0)
    c[2][1] = ix(0, 1) * ix(2, 0) - ix(0, 0) * ix(2, 1)
    c[2][2] = ix(0, 0) * ix(1, 1) - ix(0, 1) * ix(1, 0)
    det = ix(0, 0) * c[0][0] + ix(0, 1) * c[1][0] + ix(0, 2) * c[2][0]
    safe = torch.where(torch.abs(det) > 1e-30, det, torch.ones_like(det))
    return c, safe


def inv3x3(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse of [..., 3, 3] matrices."""
    c, safe = _cofactors(a, lambda i, j: a[..., i, j])
    adj = torch.stack([torch.stack(row, -1) for row in c], -2)
    return adj / safe[..., None, None]


def inv3x3_mminor(a: torch.Tensor) -> torch.Tensor:
    """Inverse of [3, 3, M] matrices (batch axis minor)."""
    c, safe = _cofactors(a, lambda i, j: a[i, j])
    return torch.stack([torch.stack(row) for row in c]) / safe
