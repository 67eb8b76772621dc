"""SE(3) and Sim(3) pose-graph optimization: LM over relative-pose edges.

Counterpart of ``vio360_tpu/solver/pose_graph.py`` (``edge_residual``,
``optimize_pose_graph``, ``sim3_edge_residual``,
``optimize_pose_graph_sim3``). The same residuals, exact per-edge
Jacobians of a right perturbation (forward-mode AD, as the reference's
come from ``jax.jacfwd``), the
dense normal equations assembled by scatter-add of the four per-edge
blocks, identity rows for fixed poses (gauge), the LM damping schedule
and exits, and the Sim(3) stall exit.

The reference pads the arrays to buckets to reuse compiles and solves the
dense system by unrolled Gauss-Jordan; here arrays are sized exactly and
the system goes to ``torch.linalg.solve``. The solve runs once, at
export, outside any kernel in both packages; the LM loop reads its
accept / reject on the host once per iteration.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.autograd.forward_ad as fwad

from ..geometry import lie


@dataclasses.dataclass
class PoseGraphResult:
    r_wb: torch.Tensor  # [P,3,3] optimized rotations
    t_wb: torch.Tensor  # [P,3]
    final_cost: torch.Tensor  # []
    initial_cost: torch.Tensor  # []
    num_iterations: int


@dataclasses.dataclass
class Sim3GraphResult:
    r_wb: torch.Tensor  # [P,3,3]
    t_wb: torch.Tensor  # [P,3]
    log_s: torch.Tensor  # [P] per-node log scale
    final_cost: torch.Tensor
    initial_cost: torch.Tensor
    num_iterations: int


def edge_residual(r_i, t_i, r_j, t_j, rel_r, rel_t):
    """r = log(T_meas^-1 T_i^-1 T_j)  [..., 6] (rho, phi)."""
    rm_inv, tm_inv = lie.se3_inverse(rel_r, rel_t)
    ri_inv, ti_inv = lie.se3_inverse(r_i, t_i)
    re, te = lie.se3_compose(ri_inv, ti_inv, r_j, t_j)
    re, te = lie.se3_compose(rm_inv, tm_inv, re, te)
    return lie.se3_log(re, te)


def sim3_edge_residual(r_i, t_i, ls_i, r_j, t_j, ls_j, rel_r, rel_t):
    """[..., 7] residual of the Sim(3) relative (Strasdat RSS'10 form):
    e_t = s_i^-1 R_i^T (t_j - t_i) - t_m, e_R = log(R_m^T R_i^T R_j),
    e_s = log s_j - log s_i."""
    rit = r_i.transpose(-1, -2)
    e_r = lie.so3_log(rel_r.transpose(-1, -2) @ (rit @ r_j))
    e_t = torch.exp(-ls_i)[..., None] * (rit @ (t_j - t_i)[..., None])[..., 0] - rel_t
    return torch.cat([e_t, e_r, (ls_j - ls_i)[..., None]], -1)


def _perturbed(xi, r, t):
    d_r, d_t = lie.se3_exp(xi)
    return lie.se3_compose(r, t, d_r, d_t)


def _se3_f(xi, r_i, t_i, r_j, t_j, rel_r, rel_t):
    ri, ti = _perturbed(xi[..., :6], r_i, t_i)
    rj, tj = _perturbed(xi[..., 6:], r_j, t_j)
    return edge_residual(ri, ti, rj, tj, rel_r, rel_t)


def _sim3_f(xi, r_i, t_i, ls_i, r_j, t_j, ls_j, rel_r, rel_t):
    ri, ti = _perturbed(xi[..., :6], r_i, t_i)
    rj, tj = _perturbed(xi[..., 7:13], r_j, t_j)
    return sim3_edge_residual(ri, ti, ls_i + xi[..., 6], rj, tj, ls_j + xi[..., 13], rel_r, rel_t)


def _jacfwd_at_zero(f, n: int, *edge_args):
    """Residuals [C,d] and Jacobians [C,d,n] of ``f(xi [..., C, n], *edge_args)``
    at xi = 0 by forward-mode AD: the n basis tangents ride a leading batch
    dimension (``jax.jacfwd``'s pushforward of each basis vector)."""
    c = edge_args[0].shape[0]
    like = edge_args[0]
    basis = torch.eye(n, dtype=like.dtype, device=like.device)[:, None, :].expand(n, c, n)
    with fwad.dual_level():
        xi = fwad.make_dual(torch.zeros(n, c, n, dtype=like.dtype, device=like.device), basis)
        primal, tangent = fwad.unpack_dual(f(xi, *edge_args))
    return primal[0], tangent.permute(1, 2, 0)


def edge_residual_jac(r_i, t_i, r_j, t_j, rel_r, rel_t):
    """Residuals [C,6] and the exact 6x6 Jacobians of right perturbations
    of T_i and T_j ([C,6,6] each)."""
    res, jac = _jacfwd_at_zero(_se3_f, 12, r_i, t_i, r_j, t_j, rel_r, rel_t)
    return res, jac[..., :6], jac[..., 6:]


def sim3_residual_jac(r_i, t_i, ls_i, r_j, t_j, ls_j, rel_r, rel_t):
    """Residuals [C,7] and the 7x7 Jacobians of (twist, log-scale)
    perturbations of node i and node j."""
    res, jac = _jacfwd_at_zero(_sim3_f, 14, r_i, t_i, ls_i, r_j, t_j, ls_j, rel_r, rel_t)
    return res, jac[..., :7], jac[..., 7:]


def _normal_equations(ei, ej, j_i, j_j, wres, p: int, d: int):
    """Dense H [dP, dP] and b [dP] from whitened per-edge Jacobians."""
    rows_i = d * ei[:, None] + torch.arange(d, device=ei.device)[None]
    rows_j = d * ej[:, None] + torch.arange(d, device=ej.device)[None]
    h = torch.zeros(d * p, d * p, dtype=j_i.dtype, device=j_i.device)
    b = torch.zeros(d * p, dtype=j_i.dtype, device=j_i.device)

    def add(rows, cols, blk):
        h.index_put_((rows[:, :, None].expand_as(blk), cols[:, None, :].expand_as(blk)), blk,
                     accumulate=True)

    add(rows_i, rows_i, torch.einsum("cri,crj->cij", j_i, j_i))
    b.index_put_((rows_i,), -torch.einsum("cri,cr->ci", j_i, wres), accumulate=True)
    add(rows_j, rows_j, torch.einsum("cri,crj->cij", j_j, j_j))
    b.index_put_((rows_j,), -torch.einsum("cri,cr->ci", j_j, wres), accumulate=True)
    hij = torch.einsum("cri,crj->cij", j_i, j_j)
    add(rows_i, rows_j, hij)
    add(rows_j, rows_i, hij.transpose(1, 2))
    return h, b


def _damped_solve(h, b, lam: float, fixed_pose, d: int):
    """Damping + gauge (fixed poses get identity rows / cols), then the step [P, d]."""
    free = (~fixed_pose).to(h.dtype).repeat_interleave(d)
    h = h + torch.diag(lam * torch.clamp(torch.diagonal(h), min=1e-6))
    h = h * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    dx = torch.linalg.solve(h, b * free).reshape(-1, d)
    return torch.where(fixed_pose[:, None], torch.zeros_like(dx), dx)


def _prepare(r_wb, ei, ej, w_sqrt, edge_valid):
    p = r_wb.shape[0]
    ei = torch.clamp(ei.long(), 0, p - 1)
    ej = torch.clamp(ej.long(), 0, p - 1)
    w_eff = torch.where(edge_valid[:, None], w_sqrt, torch.zeros_like(w_sqrt))
    return p, ei, ej, w_eff


def _cost(res, w_eff, edge_valid):
    wres = res * w_eff
    return 0.5 * torch.where(edge_valid[:, None], wres * wres, torch.zeros_like(wres)).sum()


def optimize_pose_graph(r_wb, t_wb, ei, ej, rel_r, rel_t, w_sqrt, edge_valid, fixed_pose,
                        max_iterations: int = 50) -> PoseGraphResult:
    """LM over the SE(3) graph: poses [P], edges [C] (i -> j, measured
    T_i^-1 T_j, diagonal sqrt-information [C,6]), fixed poses as gauge."""
    p, ei, ej, w_eff = _prepare(r_wb, ei, ej, w_sqrt, edge_valid)

    def cost_of(r, t):
        return _cost(edge_residual(r[ei], t[ei], r[ej], t[ej], rel_r, rel_t), w_eff, edge_valid)

    r, t = r_wb, t_wb
    init_cost = cost_of(r, t)
    cost, lam, it = float(init_cost), 1e-4, 0
    cost_t = init_cost
    while it < max_iterations and not cost < 0.0:
        res, j_i, j_j = edge_residual_jac(r[ei], t[ei], r[ej], t[ej], rel_r, rel_t)
        h, b = _normal_equations(ei, ej, j_i * w_eff[:, :, None], j_j * w_eff[:, :, None],
                                 res * w_eff, p, 6)
        dx = _damped_solve(h, b, lam, fixed_pose, 6)
        dr, dt = lie.se3_exp(dx)
        r_new, t_new = lie.se3_compose(r, t, dr, dt)
        new_cost_t = cost_of(r_new, t_new)
        new_cost = float(new_cost_t)
        accept = new_cost < cost
        if accept:
            r, t = r_new, t_new
        lam = max(lam * 0.5, 1e-9) if accept else min(lam * 4.0, 1e6)
        done = accept and (float((dx * dx).sum()) < 1e-14 or (cost - new_cost) < 1e-7 * cost)
        if accept:
            cost, cost_t = new_cost, new_cost_t
        it += 1
        if done:
            break
    return PoseGraphResult(lie.so3_renormalize(r), t, cost_t, init_cost, it)


def optimize_pose_graph_sim3(r_wb, t_wb, ei, ej, rel_r, rel_t, w_sqrt, edge_valid, fixed_pose,
                             max_iterations: int = 50) -> Sim3GraphResult:
    """LM over the Sim(3) graph (per-node log scale, [C,7] sqrt-information
    (rho, phi, sigma)); the same structure as the SE(3) solve with a
    7-dim node block, plus the reference's exit on a long reject run at
    large damping (f32 stall near the optimum)."""
    p, ei, ej, w_eff = _prepare(r_wb, ei, ej, w_sqrt, edge_valid)

    def cost_of(r, t, ls):
        return _cost(sim3_edge_residual(r[ei], t[ei], ls[ei], r[ej], t[ej], ls[ej], rel_r, rel_t),
                     w_eff, edge_valid)

    r, t = r_wb, t_wb
    ls = torch.zeros(p, dtype=r_wb.dtype, device=r_wb.device)
    init_cost = cost_of(r, t, ls)
    cost, lam, it, rejects = float(init_cost), 1e-4, 0, 0
    cost_t = init_cost
    while it < max_iterations and not cost < 0.0:
        res, j_i, j_j = sim3_residual_jac(r[ei], t[ei], ls[ei], r[ej], t[ej], ls[ej], rel_r, rel_t)
        h, b = _normal_equations(ei, ej, j_i * w_eff[:, :, None], j_j * w_eff[:, :, None],
                                 res * w_eff, p, 7)
        dx = _damped_solve(h, b, lam, fixed_pose, 7)
        dr, dt = lie.se3_exp(dx[:, :6])
        r_new, t_new = lie.se3_compose(r, t, dr, dt)
        ls_new = ls + dx[:, 6]
        new_cost_t = cost_of(r_new, t_new, ls_new)
        new_cost = float(new_cost_t)
        accept = new_cost < cost
        if accept:
            r, t, ls = r_new, t_new, ls_new
        lam = max(lam * 0.5, 1e-9) if accept else min(lam * 4.0, 1e6)
        step_small = float((dx * dx).sum()) < 1e-14
        rel_drop = (cost - new_cost) < 1e-7 * cost
        rejects = 0 if accept else rejects + 1
        # f32 stall: a long reject run counts as convergence only once the
        # damping is large (early reject runs are the damping warming up)
        done = (accept and (step_small or rel_drop)) or (rejects >= 10 and lam >= 1e2)
        if accept:
            cost, cost_t = new_cost, new_cost_t
        it += 1
        if done:
            break
    return Sim3GraphResult(lie.so3_renormalize(r), t, ls, cost_t, init_cost, it)
