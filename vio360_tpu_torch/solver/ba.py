"""Windowed bundle adjustment: LM with Schur landmark elimination.

Counterpart of ``vio360_tpu/solver/ba.py``. ``run_ba`` is what the main
path calls: kernel K2 (``ba_cuda.ba_solve``, plain version on a CPU
tensor) followed by the post-solve chi2 classification ``_classify``.
``run_ba_xla`` is the twin of the JAX package's ``_run_ba_xla_core``,
kept as an independent reference for the tests.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie
from . import ba_cuda, factors, linsolve


@dataclasses.dataclass
class BaResult:
    r_wb: torch.Tensor  # [K,3,3]
    t_wb: torch.Tensor  # [K,3]
    points: torch.Tensor  # [M,3]
    num_inliers: torch.Tensor
    num_outliers: torch.Tensor
    new_bad: torch.Tensor  # [M] bool landmarks newly marked bad
    outlier_obs: torch.Tensor  # [K,M] bool
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_iterations: torch.Tensor


def _evaluate(r_wb, t_wb, points, obs, mask, r_cb, t_cb, width, height, inv_sigma2, huber_delta):
    p_b, p_c = factors.transform_points(r_wb, t_wb, r_cb, t_cb, points)
    res = factors.reprojection_residual(p_c, obs, width, height)
    c2 = factors.chi2(res, inv_sigma2)
    d2 = huber_delta * huber_delta
    rho = torch.where(c2 <= d2, c2, 2.0 * huber_delta * torch.sqrt(torch.clamp(c2, min=1e-20)) - d2)
    return p_b, p_c, res, c2, 0.5 * torch.where(mask, rho, torch.zeros_like(rho)).sum()


def run_ba(r_wb, t_wb, points, obs_uv, obs_mask, fixed_pose, fixed_point, marginalized, r_cb,
           t_cb, width: int, height: int, pixel_noise_std: float = 1.0,
           huber_delta: float = 1.0, chi2_threshold: float = 5.991,
           max_iterations: int = 50) -> BaResult:
    """Window BA through kernel K2 (one launch for the whole LM loop)."""
    inv_sigma2 = 1.0 / (pixel_noise_std * pixel_noise_std)
    initial_cost = _evaluate(r_wb, t_wb, points, obs_uv, obs_mask, r_cb, t_cb, width, height,
                             inv_sigma2, huber_delta)[4]
    r_fin, t_fin, pts_fin, final_cost, iters = ba_cuda.ba_solve(
        r_wb, t_wb, points, obs_uv, obs_mask.float(), fixed_pose, fixed_point, 1e-4, r_cb,
        t_cb, width, height, pixel_noise_std=pixel_noise_std, huber_delta=huber_delta,
        max_iterations=max_iterations,
    )
    final_cost = torch.where(iters > 0, final_cost, initial_cost)
    return _classify(r_fin, t_fin, pts_fin, obs_uv, obs_mask, marginalized, fixed_point, r_cb,
                     t_cb, width, height, inv_sigma2, huber_delta, chi2_threshold,
                     initial_cost, final_cost, iters)


def run_ba_xla(r_wb, t_wb, points, obs_uv, obs_mask, fixed_pose, fixed_point, marginalized,
               r_cb, t_cb, width: int, height: int, pixel_noise_std: float = 1.0,
               huber_delta: float = 1.0, chi2_threshold: float = 5.991,
               max_iterations: int = 50) -> BaResult:
    """Twin of ``vio360_tpu.solver.ba._run_ba_xla_core`` (host LM loop)."""
    inv_sigma2 = 1.0 / (pixel_noise_std * pixel_noise_std)
    k, m = obs_mask.shape
    ev = lambda r, t, p: _evaluate(r, t, p, obs_uv, obs_mask, r_cb, t_cb, width, height,
                                   inv_sigma2, huber_delta)
    p_b, p_c, res, _, initial_cost = ev(r_wb, t_wb, points)
    r, t, pts = r_wb, t_wb, points
    lam, cost, it = 1e-4, initial_cost, 0
    eye3 = torch.eye(3, device=r_wb.device)
    fm = (~fixed_pose).float().repeat_interleave(6)
    while it < max_iterations:
        j_pose, j_pt = factors.reprojection_jacobians(p_b, p_c, r[:, None], r_cb, width, height)
        w = factors.robust_weights(res, obs_mask, inv_sigma2, huber_delta)
        jp = j_pose.permute(0, 2, 3, 1)  # [K,2,6,M]
        jl = j_pt.permute(0, 2, 3, 1)  # [K,2,3,M]
        rs_ = res.permute(0, 2, 1)
        u_blk = torch.einsum("kicm,km,kidm->kcd", jp, w, jp)
        v_blk = torch.einsum("kicm,km,kidm->cdm", jl, w, jl)
        w_blk = torch.einsum("kicm,km,kidm->kcdm", jp, w, jl)
        b_p = -torch.einsum("kicm,km,kim->kc", jp, w, rs_)
        b_l = -torch.einsum("kicm,km,kim->cm", jl, w, rs_)
        u_d = u_blk + lam * torch.eye(6, device=w.device) * torch.einsum("kcc->k", u_blk)[:, None, None] / 6.0
        tr_v = v_blk[0, 0] + v_blk[1, 1] + v_blk[2, 2]
        v_d = v_blk + (lam / 3.0) * eye3[:, :, None] * tr_v + 1e-8 * eye3[:, :, None]
        v_inv = torch.where(fixed_point[None, None, :], torch.zeros_like(v_d), linsolve.inv3x3_mminor(v_d))
        wv = torch.einsum("kcdm,dem->kcem", w_blk, v_inv)
        s_mat = -(wv.reshape(k * 6, 3 * m) @ w_blk.reshape(k * 6, 3 * m).T)
        s_mat = s_mat + torch.einsum("kl,kcf->kclf", torch.eye(k, device=w.device), u_d).reshape(k * 6, k * 6)
        s_mat = s_mat * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
        rhs = (b_p - torch.einsum("kcem,em->kc", wv, b_l)).reshape(k * 6) * fm
        dx = linsolve.solve(s_mat, rhs).reshape(k, 6)
        dx = torch.where(fixed_pose[:, None], torch.zeros_like(dx), dx)
        dl_m = torch.einsum("dem,em->dm", v_inv, b_l - torch.einsum("kcdm,kc->dm", w_blk, dx))
        dl = torch.where(fixed_point[:, None], torch.zeros_like(dl_m.T), dl_m.T)
        dr, dt = lie.se3_exp(dx)
        r_new, t_new = lie.se3_compose(r, t, dr, dt)
        pts_new = pts + dl
        p_b_n, p_c_n, res_n, _, new_cost = ev(r_new, t_new, pts_new)
        accept = bool(new_cost < cost)
        if accept:
            r, t, pts, p_b, p_c, res = r_new, t_new, pts_new, p_b_n, p_c_n, res_n
        lam = max(lam * 0.5, 1e-9) if accept else min(lam * 4.0, 1e6)
        step_small = bool(((dx * dx).sum() + (dl * dl).sum()) < 1e-14)
        done = (accept and (step_small or bool((cost - new_cost) < 1e-6 * cost))) or lam > 1e5
        cost = new_cost if accept else cost
        it += 1
        if done:
            break
    return _classify(r, t, pts, obs_uv, obs_mask, marginalized, fixed_point, r_cb, t_cb, width,
                     height, inv_sigma2, huber_delta, chi2_threshold, initial_cost, cost,
                     torch.tensor(it, dtype=torch.int32))


def _classify(r_fin, t_fin, pts_fin, obs_uv, obs_mask, marginalized, fixed_point, r_cb, t_cb,
              width, height, inv_sigma2, huber_delta, chi2_threshold, initial_cost, final_cost,
              iters) -> BaResult:
    """Post-solve chi2 classification (Optimizer.cpp:419-460)."""
    c2 = _evaluate(r_fin, t_fin, pts_fin, obs_uv, obs_mask, r_cb, t_cb, width, height,
                   inv_sigma2, huber_delta)[3]
    outlier_obs = obs_mask & (c2 > chi2_threshold)
    inlier_obs = obs_mask & ~outlier_obs
    new_bad = (~marginalized) & (~fixed_point) & (inlier_obs.sum(0) == 0) & (outlier_obs.sum(0) >= 2)
    return BaResult(
        r_wb=r_fin, t_wb=t_fin, points=pts_fin,
        num_inliers=inlier_obs.sum().to(torch.int32),
        num_outliers=outlier_obs.sum().to(torch.int32),
        new_bad=new_bad, outlier_obs=outlier_obs, initial_cost=initial_cost,
        final_cost=final_cost, num_iterations=iters,
    )
