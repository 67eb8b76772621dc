"""Reprojection factors: residuals + analytic Jacobians, fully batched.

Counterpart of ``vio360_tpu/solver/factors.py`` (right-perturbation pose
Jacobian, twist order [rho, phi]; >100 px residuals latched out).
"""

from __future__ import annotations

import torch

from ..geometry import camera as cam

MAX_PIXEL_ERROR = 100.0


def transform_points(r_wb, t_wb, r_cb, t_cb, points_w):
    """[K,3,3], [K,3], [3,3], [3], [M,3] -> (p_b [K,M,3], p_c [K,M,3])."""
    diff = points_w[None, :, :] - t_wb[:, None, :]
    p_b = torch.einsum("kji,kmj->kmi", r_wb, diff)
    p_c = torch.einsum("ij,kmj->kmi", r_cb, p_b) + t_cb
    return p_b, p_c


def reprojection_residual(p_c, obs_uv, width, height):
    return cam.reprojection_residual(obs_uv, p_c, width, height)


def reprojection_jacobians(p_b, p_c, r_wb, r_cb, width, height):
    """-> (J_pose [..., 2, 6], J_point [..., 2, 3]); r_wb broadcasts as [..., 3, 3]."""
    j_pc = -cam.projection_jacobian(p_c, width, height)
    j_trans = j_pc @ (-r_cb)
    x, y, z = p_b.unbind(-1)
    zero = torch.zeros_like(x)
    hat_pb = torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )
    j_rot = (j_pc @ r_cb) @ hat_pb
    r_cw = r_cb @ r_wb.transpose(-1, -2)
    return torch.cat([j_trans, j_rot], -1), j_pc @ r_cw


def chi2(residual: torch.Tensor, inv_sigma2) -> torch.Tensor:
    return (residual * residual).sum(-1) * inv_sigma2


def huber_weight(s: torch.Tensor, delta: float) -> torch.Tensor:
    return torch.where(s <= delta * delta, torch.ones_like(s), delta / torch.sqrt(torch.clamp(s, min=1e-20)))


def robust_weights(residual, active, inv_sigma2, huber_delta) -> torch.Tensor:
    """info * huber'(chi2), zeroed for inactive and >100 px residuals."""
    w = huber_weight(chi2(residual, inv_sigma2), huber_delta) * inv_sigma2
    big = (torch.abs(residual[..., 0]) > MAX_PIXEL_ERROR) | (torch.abs(residual[..., 1]) > MAX_PIXEL_ERROR)
    return torch.where(active & ~big, w, torch.zeros_like(w))
