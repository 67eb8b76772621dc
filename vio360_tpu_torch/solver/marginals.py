"""Pose marginal covariance from the window BA normal equations.

Counterpart of ``vio360_tpu/solver/marginals.py``: the pose-graph edge
weights of an evicted keyframe come from the inverse of the window's
Schur-reduced (landmark-marginalized) robust Gauss-Newton information at
its converged state, mapped to each relative pose by the exact
right-perturbation Jacobians; IMU odometry edges take theirs from the
preintegration covariance. The reduced information is assembled as in
the BA solver's LM iteration (``ba.run_ba_xla``) without damping, and
the <= 60x60 inverse is the reference's unpivoted Gauss-Jordan. It runs
once per eviction, in plain PyTorch (outside any kernel in both
packages).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import camera as cam
from ..geometry import lie
from . import factors, linsolve
from .ba import _evaluate
from .pose_graph import edge_residual_jac


def _inv_dense(a: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan inverse of a small damped-SPD matrix (linsolve.solve
    with a matrix right-hand side)."""
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    aug = torch.cat([a, eye], 1)
    for i in range(n):
        piv = aug[i] / aug[i, i]
        aug = aug - ((1.0 - eye[i]) * aug[:, i])[:, None] * piv[None, :]
        aug[i] = piv
    return aug[:, n:]


def _pose_information(r_wb, t_wb, points, obs_uv, obs_mask, fixed_pose, fixed_point, r_cb, t_cb,
                      width, height, pixel_noise_std, huber_delta):
    """Schur-reduced pose information S [6K,6K] at the current state with
    zero damping; gauge-fixed poses get identity rows / cols."""
    inv_sigma2 = 1.0 / (pixel_noise_std * pixel_noise_std)
    k, m = obs_mask.shape
    p_b, p_c, res, _, _ = _evaluate(r_wb, t_wb, points, obs_uv, obs_mask, r_cb, t_cb, width,
                                    height, inv_sigma2, huber_delta)
    j_pose, j_pt = factors.reprojection_jacobians(p_b, p_c, r_wb[:, None], r_cb, width, height)
    w = factors.robust_weights(res, obs_mask, inv_sigma2, huber_delta)
    jp = j_pose.permute(0, 2, 3, 1)  # [K,2,6,M]
    jl = j_pt.permute(0, 2, 3, 1)  # [K,2,3,M]
    u_blk = torch.einsum("kicm,km,kidm->kcd", jp, w, jp)
    v_blk = torch.einsum("kicm,km,kidm->cdm", jl, w, jl)
    w_blk = torch.einsum("kicm,km,kidm->kcdm", jp, w, jl)
    # relative ridge on the landmark blocks (see the reference: an absolute
    # one leaves the closed-form 3x3 inverse ill-conditioned in f32)
    eye3 = torch.eye(3, dtype=v_blk.dtype, device=v_blk.device)
    tr_v = v_blk[0, 0] + v_blk[1, 1] + v_blk[2, 2]
    v_d = v_blk + (1e-3 * tr_v + 1e-8) * eye3[:, :, None]
    v_inv = linsolve.inv3x3_mminor(v_d)
    v_inv = torch.where(fixed_point[None, None, :], torch.zeros_like(v_inv), v_inv)
    wv = torch.einsum("kcdm,dem->kcem", w_blk, v_inv)
    s_mat = -(wv.reshape(k * 6, 3 * m) @ w_blk.reshape(k * 6, 3 * m).T)
    s_mat = s_mat + torch.einsum("kl,kcf->kclf", torch.eye(k, dtype=u_blk.dtype, device=u_blk.device),
                                 u_blk).reshape(k * 6, k * 6)
    fm = (~fixed_pose).to(s_mat.dtype).repeat_interleave(6)
    s_mat = s_mat * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    # ridge on the free block: weakly constrained poses give a large
    # covariance, not a singular solve
    return s_mat + 1e-6 * torch.diag(fm), fm


def window_relpose_sqrt_info(r_wb, t_wb, points, obs_uv, obs_mask, fixed_pose, fixed_point, r_cb,
                             t_cb, pair_i, pair_j, width: int, height: int,
                             pixel_noise_std: float = 1.0, huber_delta: float = 1.0,
                             min_sigma_t: float = 1e-3, min_sigma_r: float = 5e-4):
    """Per-pair diagonal sqrt-information [N,6] (rho, phi) of the SE(3)
    relatives T_i^-1 T_j under the window's marginal pose covariance
    (anchors have zero covariance, so an edge out of the anchor carries
    the other endpoint's marginal alone)."""
    k = r_wb.shape[0]
    s_mat, fm = _pose_information(r_wb, t_wb, points, obs_uv, obs_mask, fixed_pose, fixed_point,
                                  r_cb, t_cb, width, height, pixel_noise_std, huber_delta)
    cov = _inv_dense(s_mat)
    cov = 0.5 * (cov + cov.T)  # symmetrize f32 inversion noise
    cov = (cov * fm[:, None] * fm[None, :]).reshape(k, 6, k, 6)
    pi, pj = pair_i.long(), pair_j.long()
    ri, ti, rj, tj = r_wb[pi], t_wb[pi], r_wb[pj], t_wb[pj]
    rel_r, rel_t = lie.se3_compose(*lie.se3_inverse(ri, ti), rj, tj)
    _, j_i, j_j = edge_residual_jac(ri, ti, rj, tj, rel_r, rel_t)
    jmat = torch.cat([j_i, j_j], 2)  # [N,6,12]
    joint = torch.cat([torch.cat([cov[pi, :, pi], cov[pi, :, pj]], 2),
                       torch.cat([cov[pj, :, pi], cov[pj, :, pj]], 2)], 1)  # [N,12,12]
    var = torch.diagonal(jmat @ joint @ jmat.transpose(1, 2), dim1=1, dim2=2)
    floor = torch.tensor([min_sigma_t ** 2] * 3 + [min_sigma_r ** 2] * 3, dtype=var.dtype,
                         device=var.device)
    # 1e-12 backstop: f32 inversion noise must never give a negative variance
    return 1.0 / torch.sqrt(torch.clamp(torch.maximum(var, floor), min=1e-12))


def preint_edge_sqrt_info_diag(cov_r_diag, cov_p_diag, dt: float, vel_sigma: float = 0.05,
                               min_sigma_t: float = 1e-3, min_sigma_r: float = 5e-4) -> tuple:
    """Diagonal sqrt-information (w_t [3], w_r [3]) of an IMU odometry edge
    from the preintegration covariance diagonals, plus the velocity
    estimate's uncertainty through the v0 dt term (host numpy, once per
    eviction)."""
    var_r = np.clip(np.asarray(cov_r_diag, np.float64), min_sigma_r ** 2, None)
    var_t = np.asarray(cov_p_diag, np.float64) + (vel_sigma * dt) ** 2
    var_t = np.clip(var_t, min_sigma_t ** 2, None)
    return ((1.0 / np.sqrt(var_t)).astype(np.float32), (1.0 / np.sqrt(var_r)).astype(np.float32))


def window_pair_sqrt_info(win, cfg, r_cb, t_cb):
    """Sqrt-information [2,6] of a window's (0,1) and (0,2) relatives from
    the marginal pose covariance at its current state, on window_ba's
    problem (same observations, gauge and boundary filter). Vision
    factors only, also after a VIBA solve: leaving out the inertial
    information can only underweight the eviction edges (see the
    reference)."""
    from ..estimator import window as window_mod

    pcfg = cfg.pose_graph
    obs_uv, obs_mask = window_mod.observations(win)
    obs_mask = obs_mask & ~cam.is_near_boundary(obs_uv, cfg.camera.width, cfg.camera.height,
                                                cfg.camera.boundary_margin)
    kf_ok = win.kf_id >= 0
    fixed_pose = ~kf_ok | (torch.arange(win.max_kf, device=kf_ok.device) == 0)
    fixed_point = ~win.lm_alive | win.lm_marg
    dev = win.kf_r.device
    return window_relpose_sqrt_info(
        win.kf_r, win.kf_t, win.lm_pos, obs_uv, obs_mask, fixed_pose, fixed_point, r_cb, t_cb,
        torch.tensor([0, 0], device=dev), torch.tensor([1, 2], device=dev), cfg.camera.width,
        cfg.camera.height, huber_delta=cfg.window.huber_delta, min_sigma_t=pcfg.min_sigma_t,
        min_sigma_r=pcfg.min_sigma_r)
