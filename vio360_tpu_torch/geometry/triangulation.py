"""Two-view triangulation for bearing-vector (360°) observations.

Counterpart of ``vio360_tpu/geometry/triangulation.py``: mid-point
triangulation (bootstrap) and homogeneous DLT (new landmarks), both
vectorized over N pairs with a validity mask and no cheirality check.
"""

from __future__ import annotations

import torch


def triangulate_midpoint(bearings1, bearings2, r_21, t_21):
    """-> (points [N, 3] in frame 1, valid [N])."""
    trans_12 = -(r_21.T @ t_21)
    b2_in_1 = bearings2 @ r_21
    d11 = (bearings1 * bearings1).sum(-1)
    d12 = (bearings1 * b2_in_1).sum(-1)
    d22 = (b2_in_1 * b2_in_1).sum(-1)
    b0 = bearings1 @ trans_12
    b1 = b2_in_1 @ trans_12
    det = d11 * (-d22) - (-d12) * d12
    valid = torch.abs(det) >= 1e-10
    safe_det = torch.where(valid, det, torch.ones_like(det))
    l1 = (b0 * (-d22) - (-d12) * b1) / safe_det
    l2 = (d11 * b1 - d12 * b0) / safe_det
    points = 0.5 * (l1[:, None] * bearings1 + (l2[:, None] * b2_in_1 + trans_12))
    valid = valid & torch.isfinite(points).all(-1)
    return torch.where(valid[:, None], points, torch.zeros_like(points)), valid


def triangulate_dlt(bearings1, bearings2, t1w, t2w):
    """-> (points [N, 3] world, valid [N]) from world->camera [3|4, 4] poses."""
    p1, p2 = t1w[:3], t2w[:3]

    def rows(b, p):
        return (
            b[:, 0:1] * p[2][None, :] - b[:, 2:3] * p[0][None, :],
            b[:, 1:2] * p[2][None, :] - b[:, 2:3] * p[1][None, :],
        )

    a0, a1 = rows(bearings1, p1)
    a2, a3 = rows(bearings2, p2)
    a = torch.stack([a0, a1, a2, a3], -2)  # [N, 4, 4]
    _, _, vt = torch.linalg.svd(a)
    h = vt[:, 3, :]
    w = h[:, 3]
    valid = torch.abs(w) >= 1e-10
    points = h[:, :3] / torch.where(valid, w, torch.ones_like(w))[:, None]
    valid = valid & torch.isfinite(points).all(-1)
    return torch.where(valid[:, None], points, torch.zeros_like(points)), valid
