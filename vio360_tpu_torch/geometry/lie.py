"""SO(3)/SE(3) Lie-group operations on torch tensors.

Counterpart of ``vio360_tpu/geometry/lie.py`` with the same conventions
(twist order ``[rho, phi]``; poses ``(R, t)`` with ``x_w = R x_b + t``).
Unlike the JAX functions, which are single-element and batched with
``vmap``, these take any leading batch dims directly: ``[..., 3]``
vectors and ``[..., 3, 3]`` matrices.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye_like(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


def hat(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrices."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] skew-symmetric -> [..., 3]."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def _coefs(phi: torch.Tensor):
    theta2 = (phi * phi).sum(-1)[..., None, None]
    theta = torch.sqrt(theta2)
    k = hat(phi)
    return theta2, theta, k, k @ k, theta < 1e-5


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation [..., 3, 3] (Rodrigues)."""
    theta2, theta, k, k2, small = _coefs(phi)
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.where(small, one, theta2)
    )
    return _eye_like(phi) + a * k + b * k2


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3] (robust at 0 and pi)."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack(
        [r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]], -1
    )
    is_small = cos_theta > 1.0 - 1e-6
    is_pi = cos_theta < -1.0 + 1e-6
    safe_cos = torch.where(is_small | is_pi, torch.zeros_like(cos_theta), cos_theta)
    theta_safe = torch.arccos(safe_cos)
    generic = w * (theta_safe / (2.0 * torch.sin(theta_safe)))[..., None]

    w2 = (w * w).sum(-1, keepdim=True)
    small = 0.5 * w * (1.0 + w2 / 24.0)

    theta_pi = torch.arccos(torch.clamp(cos_theta, -1.0, 0.0))
    diag = torch.stack([r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], -1)
    axis_sq = torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0)
    k = torch.argmax(axis_sq, -1, keepdim=True)
    ax = torch.sqrt(torch.clamp(torch.gather(axis_sq, -1, k), min=_EPS))
    cols = r + _eye_like(r)  # [..., 3, 3]; column k of (R + I)
    col = torch.gather(cols, -1, k[..., None, :].expand(*cols.shape[:-1], 1))[..., 0] / (2.0 * ax)
    col = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=_EPS)
    sign = 1.0 - 2.0 * ((col * w).sum(-1, keepdim=True) < 0.0).to(r.dtype)
    near_pi = theta_pi[..., None] * sign * col
    return torch.where(
        is_small[..., None], small, torch.where(is_pi[..., None], near_pi, generic)
    )


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(phi): exp(phi + dphi) ~ exp(phi) exp(Jr dphi)."""
    theta2, theta, k, k2, small = _coefs(phi)
    one = torch.ones_like(theta)
    safe_t2 = torch.where(small, one, theta2)
    safe_t3 = torch.where(small, one, theta2 * theta)
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / safe_t3)
    return _eye_like(phi) - a * k + b * k2


def _se3_v_matrix(phi: torch.Tensor) -> torch.Tensor:
    theta2, theta, k, k2, small = _coefs(phi)
    one = torch.ones_like(theta)
    safe_t2 = torch.where(small, one, theta2)
    safe_t3 = torch.where(small, one, theta2 * theta)
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / safe_t3)
    return _eye_like(phi) + a * k + b * k2


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Twist [..., 6] = [rho, phi] -> (R [..., 3, 3], t [..., 3])."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3_exp(phi), (_se3_v_matrix(phi) @ rho[..., None])[..., 0]


def _se3_v_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2, theta, k, k2, small = _coefs(phi)
    one = torch.ones_like(theta)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    safe_t2 = torch.where(small, one, theta2)
    den = 2.0 * theta * torch.where(torch.abs(sin_t) < _EPS, one, sin_t)
    safe_den = torch.where(small, one, den)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, 1.0 / safe_t2 - (1.0 + cos_t) / safe_den)
    return _eye_like(phi) - 0.5 * k + c * k2


def se3_log(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R [..., 3, 3], t [..., 3]) -> twist [..., 6] = [rho, phi] with t = V(phi) rho."""
    phi = so3_log(r)
    rho = (_se3_v_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_inverse(r: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    rt = r.transpose(-1, -2)
    return rt, -(rt @ t[..., None])[..., 0]


def se3_compose(r1, t1, r2, t2) -> tuple[torch.Tensor, torch.Tensor]:
    """(R1, t1) * (R2, t2)."""
    return r1 @ r2, (r1 @ t2[..., None])[..., 0] + t1


def so3_renormalize(r: torch.Tensor) -> torch.Tensor:
    """Two polar-iteration Newton steps R <- R(3I - R^T R)/2 onto SO(3)
    (load-bearing: see the JAX docstring; without it the constant-
    velocity prediction amplifies off-manifold float32 error)."""
    eye = _eye_like(r)
    for _ in range(2):
        r = 0.5 * (r @ (3.0 * eye - r.transpose(-1, -2) @ r))
    return r


def slerp(r0: torch.Tensor, r1: torch.Tensor, alpha) -> torch.Tensor:
    d = r0.transpose(-1, -2) @ r1
    return r0 @ so3_exp(alpha * so3_log(d))


def interpolate_pose(r0, t0, r1, t1, alpha):
    """Slerp rotation + lerp translation."""
    return slerp(r0, r1, alpha), (1.0 - alpha) * t0 + alpha * t1
