"""Single-pose PnP via on-manifold Levenberg-Marquardt.

Counterpart of ``vio360_tpu/solver/pnp.py``: 4 rounds of [LM solve ->
chi2 classification], outliers latched across rounds, marginalized
landmarks never outliers, Huber(1.0), >= 10 inliers required else the
predicted pose is kept; every round restarts from the initial pose.

``solve_pnp`` is the dispatcher the main path calls: it runs kernel K1
(``ba_cuda.pnp_solve``), which on a CPU tensor takes its plain version;
loop verification and relocalization give it a batch of candidates.
``solve_pnp_xla`` is the twin of the JAX package's XLA formulation,
kept as an independent reference for the tests.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie
from . import ba_cuda, factors, linsolve


@dataclasses.dataclass
class PnpResult:
    r_wb: torch.Tensor  # [3,3] optimized (or kept) pose
    t_wb: torch.Tensor  # [3]
    success: torch.Tensor  # [] bool
    num_inliers: torch.Tensor  # [] int32
    num_outliers: torch.Tensor  # [] int32
    outlier: torch.Tensor  # [N] bool latched outlier flags
    final_cost: torch.Tensor  # [] f32 mean inlier chi2


def _finish(r_init, t_init, r_fin, t_fin, active, num_inliers, num_outliers, outlier,
            final_cost, min_inliers) -> PnpResult:
    success = (active.sum(-1) >= 6) & (num_inliers >= min_inliers)
    # Snap onto SO(3) on the way out: PnP output feeds the next frame's
    # constant-velocity prediction, which amplifies off-manifold error.
    r_out = lie.so3_renormalize(torch.where(success[..., None, None], r_fin, r_init))
    t_out = torch.where(success[..., None], t_fin, t_init)
    return PnpResult(r_out, t_out, success, num_inliers, num_outliers, outlier, final_cost)


def solve_pnp(r_wb_init, t_wb_init, points_w, obs_uv, active, marginalized, r_cb, t_cb,
              width: int, height: int, pixel_noise_std: float = 1.0, huber_delta: float = 1.0,
              chi2_threshold: float = 5.991, rounds: int = 4, max_iterations: int = 50,
              min_inliers: int = 10) -> PnpResult:
    """PnP through kernel K1 (one launch for all rounds). With a leading
    batch dimension B on the pose, points, observations and masks, B
    independent problems go to K1 in one launch and every field of the
    result gains that dimension (the JAX package's ``vmap`` of
    ``solve_pnp``)."""
    r_fin, t_fin, outlier, final_cost, n_inl, n_out = ba_cuda.pnp_solve(
        r_wb_init, t_wb_init, points_w, obs_uv, active, marginalized, 1e-4, r_cb, t_cb,
        width, height, pixel_noise_std=pixel_noise_std, huber_delta=huber_delta,
        chi2_threshold=chi2_threshold, rounds=rounds, max_iterations=max_iterations,
    )
    return _finish(r_wb_init, t_wb_init, r_fin, t_fin, active, n_inl, n_out, outlier,
                   final_cost, min_inliers)


def _evaluate(r_wb, t_wb, points, obs, active, r_cb, t_cb, width, height, inv_sigma2, huber_delta):
    p_b, p_c = factors.transform_points(r_wb[None], t_wb[None], r_cb, t_cb, points)
    res = factors.reprojection_residual(p_c[0], obs, width, height)
    c2 = factors.chi2(res, inv_sigma2)
    d2 = huber_delta * huber_delta
    rho = torch.where(c2 <= d2, c2, 2.0 * huber_delta * torch.sqrt(torch.clamp(c2, min=1e-20)) - d2)
    cost = 0.5 * torch.where(active, rho, torch.zeros_like(rho)).sum()
    return p_b[0], p_c[0], res, c2, cost


def solve_pnp_xla(r_wb_init, t_wb_init, points_w, obs_uv, active, marginalized, r_cb, t_cb,
                  width: int, height: int, pixel_noise_std: float = 1.0,
                  huber_delta: float = 1.0, chi2_threshold: float = 5.991, rounds: int = 4,
                  max_iterations: int = 50, min_inliers: int = 10) -> PnpResult:
    """Twin of ``vio360_tpu.solver.pnp.solve_pnp_xla`` (host LM loop)."""
    inv_sigma2 = 1.0 / (pixel_noise_std * pixel_noise_std)
    n = points_w.shape[0]
    outlier = torch.zeros(n, dtype=torch.bool, device=points_w.device)
    r_fin, t_fin = r_wb_init, t_wb_init
    final_cost = torch.zeros((), device=points_w.device)
    ev = lambda r, t, use: _evaluate(r, t, points_w, obs_uv, use, r_cb, t_cb, width, height,
                                     inv_sigma2, huber_delta)
    for _ in range(rounds):
        use = active & ~outlier
        r, t = r_wb_init, t_wb_init
        lam = 1e-4
        cost = ev(r, t, use)[4]
        for _it in range(max_iterations):
            p_b, p_c, res, _, _ = ev(r, t, use)
            j_pose, _ = factors.reprojection_jacobians(p_b, p_c, r, r_cb, width, height)
            w = factors.robust_weights(res, use, inv_sigma2, huber_delta)
            jp = j_pose.permute(1, 2, 0)  # [2, 6, N]
            h = torch.einsum("icn,n,idn->cd", jp, w, jp)
            gv = torch.einsum("icn,n,in->c", jp, w, res.T)
            damped = h + lam * torch.diag(torch.diag(h)) + 1e-10 * torch.eye(6, device=h.device)
            delta = -linsolve.solve(damped, gv)
            dr, dt = lie.se3_exp(delta)
            r_new, t_new = lie.se3_compose(r, t, dr, dt)
            new_cost = ev(r_new, t_new, use)[4]
            accept = bool(new_cost < cost)
            if accept:
                r, t = r_new, t_new
            lam = max(lam * 0.5, 1e-9) if accept else min(lam * 4.0, 1e6)
            done = (accept and (bool((delta * delta).sum() < 1e-16)
                                or bool((cost - new_cost) < 1e-6 * cost))) or lam > 1e5
            cost = new_cost if accept else cost
            if done:
                break
        _, _, _, c2, _ = ev(r, t, active)
        outlier = active & ~marginalized & (c2 > chi2_threshold)
        r_fin, t_fin = r, t
        inl = active & ~outlier
        final_cost = torch.where(inl, c2, torch.zeros_like(c2)).sum() / torch.clamp(inl.sum(), min=1)
    inl = active & ~outlier
    return _finish(r_wb_init, t_wb_init, r_fin, t_fin, active, inl.sum().to(torch.int32),
                   outlier.sum().to(torch.int32), outlier, final_cost, min_inliers)
