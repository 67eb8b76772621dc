"""Visual-inertial initialization: gravity, scale, velocities, biases.

Counterpart of ``vio360_tpu/solver/imu_init.py``: a closed-form linear
alignment of (scaled velocities, gravity, scale), then two small dense
LM stages on the 9-dim inertial residual of every consecutive keyframe
pair (stage 1: gravity direction + scale; stage 2: velocities + biases
under weak zero-bias priors), and the world re-alignment that follows.

The pair residuals are evaluated for all pairs at once (the JAX module
unrolls a Python loop over pairs); Jacobians come from
``torch.func.jacfwd`` as the reference's come from ``jax.jacfwd``. The
LM iterations run as a host loop with one read of two flags each
(accepted, stop); the damped normal equations go to
``torch.linalg.solve_ex``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie
from ..imu.preintegration import Preintegration


@dataclasses.dataclass
class ImuInitResult:
    success: torch.Tensor
    gravity_dir: torch.Tensor  # [2] (theta_x, theta_y)
    gravity_w: torch.Tensor  # [3]
    scale: torch.Tensor  # []
    velocities: torch.Tensor  # [K, 3]
    bg: torch.Tensor  # [3]
    ba: torch.Tensor  # [3]
    stage1_cost: torch.Tensor
    stage2_cost: torch.Tensor


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def gravity_dir_to_rotation(gdir: torch.Tensor) -> torch.Tensor:
    """[theta_x, theta_y] -> R_wg (rotation vector with zero z)."""
    return lie.so3_exp(torch.cat([gdir, torch.zeros_like(gdir[:1])]))


def _sqrt_information(cov9: torch.Tensor, floor: float = 1e-6, scale: float = 1e-6,
                      ridge: float = 1e-12) -> torch.Tensor:
    """[..., 9, 9] covariance -> upper Cholesky factor of the eigen-clamped
    inverse times ``scale`` (the init stage's 1e-6 down-weighting)."""
    s, u = torch.linalg.eigh(0.5 * (cov9 + cov9.transpose(-1, -2)))
    s = torch.clamp(s, min=floor)
    info = (u * (1.0 / s)[..., None, :]) @ u.transpose(-1, -2) * scale
    eye = torch.eye(9, dtype=cov9.dtype, device=cov9.device)
    return torch.linalg.cholesky(info + ridge * eye).transpose(-1, -2)


def bias_corrected_deltas(pre: Preintegration, bg, ba):
    """First-order bias correction of every pair's deltas: (dR, dV, dP)."""
    dbg, dba = bg - pre.bg, ba - pre.ba
    delta_r = pre.delta_r @ lie.so3_exp(_mv(pre.j_rg, dbg))
    delta_v = pre.delta_v + _mv(pre.j_vg, dbg) + _mv(pre.j_va, dba)
    delta_p = pre.delta_p + _mv(pre.j_pg, dbg) + _mv(pre.j_pa, dba)
    return delta_r, delta_v, delta_p


def pair_residuals(kf_r, kf_t, vel, bg, ba, g, scale, pre: Preintegration) -> torch.Tensor:
    """[K-1, 9] unweighted residuals (er, ev, ep) of pairs (i, i+1)."""
    dt = pre.dt_total[:, None]
    delta_r, delta_v, delta_p = bias_corrected_deltas(pre, bg, ba)
    r_bwi = kf_r[:-1].transpose(-1, -2)
    er = lie.so3_log(delta_r.transpose(-1, -2) @ r_bwi @ kf_r[1:])
    ev = _mv(r_bwi, scale * (vel[1:] - vel[:-1]) - g * dt) - delta_v
    ep = _mv(r_bwi, scale * (kf_t[1:] - kf_t[:-1] - vel[:-1] * dt) - 0.5 * g * dt * dt) - delta_p
    return torch.cat([er, ev, ep], -1)


def _lm_minimize(residual_fn, x0: torch.Tensor, iters: int = 50):
    """Tiny dense LM on ``residual_fn(x) -> [R]`` (weighted residuals).

    The same iterates as the reference's ``while_loop``, with less work:
    the linearization is recomputed only after an accepted step (a
    rejected one leaves x, hence the Jacobian, unchanged), and a step
    rejected at the damping cap ends the loop, since every later
    iteration would repeat it exactly."""

    def cost(x):
        r = residual_fn(x)
        return 0.5 * (r * r).sum()

    n = x0.shape[0]
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    x, c = x0, cost(x0)
    lam = torch.tensor(1e-3, dtype=x0.dtype, device=x0.device)
    lin = None
    for _ in range(iters):
        if lin is None:
            j = torch.func.jacfwd(residual_fn)(x)
            lin = (j.T @ j, j.T @ residual_fn(x))
        h, g = lin
        damped = h + lam * torch.diag(torch.diag(h)) + 1e-12 * eye
        dx = -torch.linalg.solve_ex(damped, g)[0]
        c_new = cost(x + dx)
        accept = c_new < c
        stop = (accept & ((c - c_new) < 1e-8 * c)) | (~accept & (lam >= 1e8))
        x = torch.where(accept, x + dx, x)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), torch.clamp(lam * 4.0, max=1e8))
        c = torch.where(accept, c_new, c)
        accepted, stopped = torch.stack([accept, stop]).tolist()
        if stopped:
            break
        if accepted:
            lin = None
    return x, c


def _linear_init(kf_r, kf_t, pre: Preintegration, pair_valid):
    """Closed-form (w = s v, g, s) from the linear ev / ep rows:
    R_bwi (w_j - w_i - g dt) = dV_i and
    R_bwi (s (t_j - t_i) - w_i dt - g dt^2 / 2) = dP_i, min-norm lstsq."""
    k = kf_r.shape[0]
    n_unk = 3 * k + 4
    a = torch.zeros(k - 1, 2, 3, n_unk, dtype=kf_r.dtype, device=kf_r.device)
    r_bw = kf_r[:-1].transpose(-1, -2)  # [P, 3, 3]
    dt = pre.dt_total[:, None, None]
    for i in range(k - 1):
        a[i, 0, :, 3 * i:3 * i + 3] = -r_bw[i]
        a[i, 0, :, 3 * (i + 1):3 * (i + 1) + 3] = r_bw[i]
        a[i, 1, :, 3 * i:3 * i + 3] = -r_bw[i] * dt[i]
    a[:, 0, :, 3 * k:3 * k + 3] = -r_bw * dt
    a[:, 1, :, 3 * k:3 * k + 3] = -0.5 * r_bw * dt * dt
    a[:, 1, :, 3 * k + 3] = _mv(r_bw, kf_t[1:] - kf_t[:-1])
    w = pair_valid.to(kf_r.dtype)
    a = (a * w[:, None, None, None]).reshape(-1, n_unk)
    b = (torch.stack([pre.delta_v, pre.delta_p], 1) * w[:, None, None]).reshape(-1)
    x = torch.linalg.pinv(a) @ b
    return x[:3 * k].reshape(k, 3), x[3 * k:3 * k + 3], x[3 * k + 3]


def _gravity_to_dir(g: torch.Tensor) -> torch.Tensor:
    """World gravity vector -> (theta_x, theta_y) with R_wg (0,0,-1) ~ g_hat."""
    g_hat = g / torch.clamp(torch.linalg.norm(g), min=1e-9)
    e = torch.tensor([0.0, 0.0, -1.0], dtype=g.dtype, device=g.device)
    axis = torch.linalg.cross(e, g_hat)
    s_norm = torch.linalg.norm(axis)
    angle = torch.atan2(s_norm, (e * g_hat).sum())
    return (axis / torch.clamp(s_norm, min=1e-9) * angle)[:2]


def solve_imu_init(kf_r, kf_t, preints: Preintegration, pair_valid,
                   gravity_magnitude: float = 9.81, max_iterations: int = 50) -> ImuInitResult:
    """Gravity / scale / velocities / biases of a window of K keyframes
    from its K-1 stacked pair preintegrations."""
    k = kf_r.shape[0]
    dev, dt_ = kf_r.device, kf_r.dtype
    sqrt_infos = _sqrt_information(preints.cov[:, :9, :9])
    g0 = torch.tensor([0.0, 0.0, -gravity_magnitude], dtype=dt_, device=dev)
    z3 = torch.zeros(3, dtype=dt_, device=dev)

    w_lin, g_lin, s_lin = _linear_init(kf_r, kf_t, preints, pair_valid)
    s_lin = torch.clamp(s_lin, min=1e-3)
    v_init = w_lin / s_lin
    gdir_init = _gravity_to_dir(g_lin)

    def residuals(vel, bg, ba, gdir, scale):
        g = gravity_dir_to_rotation(gdir) @ g0
        rw = _mv(sqrt_infos, pair_residuals(kf_r, kf_t, vel, bg, ba, g, scale, preints))
        r2 = (rw * rw).sum(-1)
        hub = torch.sqrt(torch.where(r2 <= 16.0, torch.ones_like(r2),
                                     torch.sqrt(16.0 / torch.clamp(r2, min=1e-20))))
        return torch.where(pair_valid[:, None], hub[:, None] * rw, torch.zeros_like(rw)).reshape(-1)

    x1, cost1 = _lm_minimize(lambda x: residuals(v_init, z3, z3, x[:2], x[2]),
                             torch.cat([gdir_init, s_lin[None]]), max_iterations)
    gdir, scale = x1[:2], x1[2]

    def stage2_res(x):
        r = residuals(x[:3 * k].reshape(k, 3), x[3 * k:3 * k + 3], x[3 * k + 3:], gdir, scale)
        return torch.cat([r, 1e-3 * x[3 * k:]])  # weak zero-bias prior

    x2, cost2 = _lm_minimize(stage2_res, torch.cat([v_init.reshape(-1), torch.zeros(6, dtype=dt_, device=dev)]),
                             max_iterations)
    success = (pair_valid.sum() >= 2) & (scale > 1e-3) & torch.isfinite(cost2)
    return ImuInitResult(
        success=success, gravity_dir=gdir, gravity_w=gravity_dir_to_rotation(gdir) @ g0,
        scale=scale, velocities=x2[:3 * k].reshape(k, 3), bg=x2[3 * k:3 * k + 3],
        ba=x2[3 * k + 3:], stage1_cost=cost1, stage2_cost=cost2,
    )


def align_gravity_and_scale(kf_r, kf_t, kf_vel, points, r_wg, scale):
    """Rotate the world by R_gw = R_wg^T (gravity -> (0,0,-G)), then scale
    translations / velocities / points by ``scale`` about the first keyframe."""
    r_gw = r_wg.T
    kf_r2 = r_gw @ kf_r
    kf_t2, vel2, pts2 = kf_t @ r_gw.T, kf_vel @ r_gw.T, points @ r_gw.T
    t0 = kf_t2[0]
    return kf_r2, t0 + (kf_t2 - t0) * scale, vel2 * scale, t0 + (pts2 - t0) * scale
