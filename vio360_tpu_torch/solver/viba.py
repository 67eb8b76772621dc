"""Visual-inertial windowed bundle adjustment.

Counterpart of ``vio360_tpu/solver/viba.py::_run_viba_core`` (no Pallas
kernel in the reference). Parameters y = [pose twists (6K) | velocities
(3K) | bg (3) ba (3)] with window-shared biases; landmarks are Schur-
eliminated with the analytic reprojection Jacobians, and the reduced
visual system is embedded in the pose block of the dense (9K+6)^2
system. The inertial residuals (known gravity, scale 1) and their
bias priors enter with full Jacobians from ``torch.func.jacfwd``, as
the reference's come from ``jax.jacfwd``.

The LM loop is a host loop with one read of two flags per iteration
(accepted, stop); the damping stays on the device. It makes the
reference's iterates with less work: the linearization (Jacobians,
normal blocks, the inertial jacfwd) is recomputed only after an
accepted step, and a step rejected at the damping cap ends the loop,
since every later iteration would repeat it exactly. The dense system
goes to ``torch.linalg.solve_ex``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie
from ..imu.preintegration import Preintegration
from . import factors, linsolve
from .imu_init import _mv, _sqrt_information, bias_corrected_deltas


@dataclasses.dataclass
class VibaResult:
    r_wb: torch.Tensor  # [K,3,3]
    t_wb: torch.Tensor  # [K,3]
    vel: torch.Tensor  # [K,3]
    bg: torch.Tensor  # [3]
    ba: torch.Tensor  # [3]
    points: torch.Tensor  # [M,3]
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_iterations: torch.Tensor
    outlier_obs: torch.Tensor  # [K,M]
    new_bad: torch.Tensor  # [M]
    num_inliers: torch.Tensor


def _inertial_residuals(r_wb, t_wb, vel, bg, ba, pre: Preintegration, pair_valid, sqrt_infos,
                        gravity_w) -> torch.Tensor:
    """Stacked weighted inertial residuals [(K-1) * 9]."""
    dt = pre.dt_total[:, None]
    delta_r, delta_v, delta_p = bias_corrected_deltas(pre, bg, ba)
    r_bwi = r_wb[:-1].transpose(-1, -2)
    er = lie.so3_log(delta_r.transpose(-1, -2) @ r_bwi @ r_wb[1:])
    ev = _mv(r_bwi, vel[1:] - vel[:-1] - gravity_w * dt) - delta_v
    ep = _mv(r_bwi, t_wb[1:] - t_wb[:-1] - vel[:-1] * dt - 0.5 * gravity_w * dt * dt) - delta_p
    r9 = _mv(sqrt_infos, torch.cat([er, ev, ep], -1))
    return torch.where(pair_valid[:, None], r9, torch.zeros_like(r9)).reshape(-1)


def run_viba(r_wb, t_wb, vel, bg, ba_bias, points, obs_uv, obs_mask, fixed_pose, fixed_point,
             marginalized, preints: Preintegration, pair_valid, gravity_w, r_cb, t_cb, width: int,
             height: int, pixel_noise_std: float = 1.0, huber_delta: float = 1.0,
             chi2_threshold: float = 5.991, max_iterations: int = 20, inertial_weight: float = 1.0,
             bg_prior_weight: float = 50.0, ba_prior_weight: float = 50.0) -> VibaResult:
    inv_sigma2 = 1.0 / (pixel_noise_std * pixel_noise_std)
    k, m = obs_mask.shape
    n_par = 9 * k + 6
    dev = r_wb.device
    eye3 = torch.eye(3, device=dev)
    # the physically correct information (no 1e-6 down-weighting)
    sqrt_infos = _sqrt_information(preints.cov[:, :9, :9], floor=1e-10, scale=1.0,
                                   ridge=1e-8) * inertial_weight

    def vis_eval(r, t, pts):
        p_b, p_c = factors.transform_points(r, t, r_cb, t_cb, pts)
        res = factors.reprojection_residual(p_c, obs_uv, width, height)
        c2 = factors.chi2(res, inv_sigma2)
        d2 = huber_delta * huber_delta
        rho = torch.where(c2 <= d2, c2,
                          2.0 * huber_delta * torch.sqrt(torch.clamp(c2, min=1e-20)) - d2)
        return p_b, p_c, res, c2, 0.5 * torch.where(obs_mask, rho, torch.zeros_like(rho)).sum()

    def with_prior(ri, bgx, bax):
        return torch.cat([ri, bg_prior_weight * bgx, ba_prior_weight * bax])

    def total_cost(r, t, pts, v, bgx, bax):
        ri = with_prior(_inertial_residuals(r, t, v, bgx, bax, preints, pair_valid, sqrt_infos,
                                            gravity_w), bgx, bax)
        return vis_eval(r, t, pts)[4] + 0.5 * (ri * ri).sum()

    def retract(r, t, dxi):
        dr, dt = lie.se3_exp(dxi)
        return lie.se3_compose(r, t, dr, dt)

    free = torch.ones(n_par, dtype=torch.bool, device=dev)
    free[:6 * k] = (~fixed_pose).repeat_interleave(6)
    fmask = free.to(torch.float32)
    eye_n = torch.eye(n_par, device=dev)

    init_cost = total_cost(r_wb, t_wb, points, vel, bg, ba_bias)
    r, t, pts, v, bgx, bax = r_wb, t_wb, points, vel, bg, ba_bias
    lam = torch.tensor(1e-4, device=dev)
    cost = init_cost
    it = 0
    lin = None
    while it < max_iterations:
        if lin is None:  # the linearization changes only when a step is accepted
            # visual part: analytic Jacobians, landmarks Schur-eliminated below
            p_b, p_c, res, _, _ = vis_eval(r, t, pts)
            j_pose, j_pt = factors.reprojection_jacobians(p_b, p_c, r[:, None], r_cb, width, height)
            wgt = factors.robust_weights(res, obs_mask, inv_sigma2, huber_delta)
            v_blk = torch.einsum("kmic,km,kmid->mcd", j_pt, wgt, j_pt)
            w_blk = torch.einsum("kmic,km,kmid->kmcd", j_pose, wgt, j_pt)
            b_l = -torch.einsum("kmic,km,kmi->mc", j_pt, wgt, res)

            # inertial part: autodiff over the perturbation
            def inertial_of_delta(delta):
                r_n, t_n = retract(r, t, delta[:6 * k].reshape(k, 6))
                dbg_, dba_ = delta[9 * k:9 * k + 3], delta[9 * k + 3:]
                ri = _inertial_residuals(r_n, t_n, v + delta[6 * k:9 * k].reshape(k, 3),
                                         bgx + dbg_, bax + dba_, preints, pair_valid,
                                         sqrt_infos, gravity_w)
                return with_prior(ri, bgx + dbg_, bax + dba_)

            zero = torch.zeros(n_par, device=dev)
            j_in = torch.func.jacfwd(inertial_of_delta)(zero)
            lin = dict(
                u_blk=torch.einsum("kmic,km,kmid->kcd", j_pose, wgt, j_pose), v_blk=v_blk,
                w_blk=w_blk, b_p=-torch.einsum("kmic,km,kmi->kc", j_pose, wgt, res), b_l=b_l,
                tr_v=torch.einsum("mcc->m", v_blk), h_in=j_in.T @ j_in,
                g_in=j_in.T @ inertial_of_delta(zero))
        u_blk, w_blk, b_l = lin["u_blk"], lin["w_blk"], lin["b_l"]
        v_d = lin["v_blk"] + lam * eye3 * lin["tr_v"][:, None, None] / 3.0 + 1e-8 * eye3
        v_inv = torch.where(fixed_point[:, None, None], torch.zeros_like(v_d), linsolve.inv3x3(v_d))
        wv = torch.einsum("kmcd,mde->kmce", w_blk, v_inv)
        s_vis = -(wv.permute(0, 2, 1, 3).reshape(6 * k, 3 * m)
                  @ w_blk.permute(0, 2, 1, 3).reshape(6 * k, 3 * m).T)
        s_vis = s_vis + torch.block_diag(*u_blk)
        rhs_vis = lin["b_p"] - torch.einsum("kmce,me->kc", wv, b_l)
        # the reduced visual system embedded in the pose block
        h = lin["h_in"] + torch.nn.functional.pad(s_vis, (0, n_par - 6 * k, 0, n_par - 6 * k))
        g = lin["g_in"] - torch.nn.functional.pad(rhs_vis.reshape(6 * k), (0, n_par - 6 * k))
        # damping + gauge
        h = h + lam * torch.diag(torch.diag(h)) + 1e-8 * eye_n
        h = h * fmask[:, None] * fmask[None, :] + torch.diag(1.0 - fmask)
        delta = -torch.linalg.solve_ex(h, g * fmask)[0]

        dxi = delta[:6 * k].reshape(k, 6)
        r_new, t_new = retract(r, t, dxi)
        v_new = v + delta[6 * k:9 * k].reshape(k, 3)
        bg_new, ba_new = bgx + delta[9 * k:9 * k + 3], bax + delta[9 * k + 3:]
        dl = torch.einsum("mde,me->md", v_inv, b_l - torch.einsum("kmcd,kc->md", w_blk, dxi))
        pts_new = pts + torch.where(fixed_point[:, None], torch.zeros_like(dl), dl)

        new_cost = total_cost(r_new, t_new, pts_new, v_new, bg_new, ba_new)
        accept = new_cost < cost
        # a step rejected at the damping cap would repeat in every later iteration
        stop = (accept & ((cost - new_cost) < 1e-6 * cost)) | (~accept & (lam >= 1e6))
        r = torch.where(accept, r_new, r)
        t = torch.where(accept, t_new, t)
        pts = torch.where(accept, pts_new, pts)
        v = torch.where(accept, v_new, v)
        bgx = torch.where(accept, bg_new, bgx)
        bax = torch.where(accept, ba_new, bax)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), torch.clamp(lam * 4.0, max=1e6))
        cost = torch.where(accept, new_cost, cost)
        it += 1
        accepted, stopped = torch.stack([accept, stop]).tolist()
        if stopped:
            break
        if accepted:
            lin = None

    # chi2 classification identical to run_ba
    c2 = vis_eval(r, t, pts)[3]
    outlier_obs = obs_mask & (c2 > chi2_threshold)
    inlier_obs = obs_mask & ~outlier_obs
    new_bad = ((~marginalized) & (~fixed_point) & (inlier_obs.sum(0) == 0)
               & (outlier_obs.sum(0) >= 2))
    return VibaResult(
        r_wb=r, t_wb=t, vel=v, bg=bgx, ba=bax, points=pts, initial_cost=init_cost,
        final_cost=cost, num_iterations=torch.tensor(it, dtype=torch.int32), outlier_obs=outlier_obs,
        new_bad=new_bad, num_inliers=inlier_obs.sum().to(torch.int32),
    )
