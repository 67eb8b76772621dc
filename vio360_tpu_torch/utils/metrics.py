"""Trajectory evaluation: ATE / RPE with Umeyama alignment, and the
evaluator of two TUM files.

The port's own copy of ``vio360_tpu/utils/metrics.py`` (numpy only), plus
``evaluate_tum``, the in-process form of ``tools/evaluate_ate.py``: the
same association rule (nearest ground-truth timestamp within 0.02 s) and
the same output keys. Monocular VO has a gauge freedom (global SE(3) and
scale), so ATE is taken after a Sim(3) or SE(3) alignment.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: association window of ``evaluate_tum`` (s)
MAX_DT = 0.02


@dataclasses.dataclass
class AteResult:
    rmse: float
    mean: float
    median: float
    max: float
    scale: float
    n: int


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform dst ~= s R src + t -> (s, R [3,3], t [3])."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        scale = float(np.trace(np.diag(d) @ s_mat) / max(var_s, 1e-12))
    else:
        scale = 1.0
    t = mu_d - scale * r @ mu_s
    return scale, r, t


def ate(est_positions: np.ndarray, gt_positions: np.ndarray, align: str = "sim3") -> AteResult:
    """Absolute trajectory error after alignment: "sim3" (scale + SE(3)),
    "se3" or "none"."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape, (est.shape, gt.shape)
    if align == "sim3":
        s, r, t = umeyama_alignment(est, gt, with_scale=True)
    elif align == "se3":
        s, r, t = umeyama_alignment(est, gt, with_scale=False)
    else:
        s, r, t = 1.0, np.eye(3), np.zeros(3)
    aligned = s * est @ r.T + t
    err = np.linalg.norm(aligned - gt, axis=-1)
    return AteResult(rmse=float(np.sqrt((err**2).mean())), mean=float(err.mean()),
                     median=float(np.median(err)), max=float(err.max()), scale=float(s),
                     n=len(err))


def rpe(est_r: np.ndarray, est_t: np.ndarray, gt_r: np.ndarray, gt_t: np.ndarray,
        delta: int = 1):
    """Relative pose error over frame pairs (i, i + delta) -> (trans_rmse, rot_rmse_deg)."""
    est_r, est_t = np.asarray(est_r), np.asarray(est_t)
    gt_r, gt_t = np.asarray(gt_r), np.asarray(gt_t)
    et, er = [], []
    for i in range(len(est_t) - delta):
        def rel(rs, ts):
            r1, t1 = rs[i], ts[i]
            r2, t2 = rs[i + delta], ts[i + delta]
            return r1.T @ r2, r1.T @ (t2 - t1)

        dr_e, dt_e = rel(est_r, est_t)
        dr_g, dt_g = rel(gt_r, gt_t)
        err_r = dr_g.T @ dr_e
        et.append(np.linalg.norm(dt_e - dt_g))
        er.append(np.degrees(np.arccos(np.clip((np.trace(err_r) - 1) / 2, -1, 1))))
    et, er = np.asarray(et), np.asarray(er)
    return float(np.sqrt((et**2).mean())), float(np.sqrt((er**2).mean()))


def evaluate_tum(est_path: str, gt_path: str, align: str = "sim3") -> dict:
    """``tools/evaluate_ate.py``'s record for two TUM files: each estimate
    associated with the nearest ground-truth timestamp within ``MAX_DT``;
    ATE under ``align`` and always the SE(3) ATE, the sim3 ATE, its scale
    and scale error, and the RPE. ``{"error": ...}`` with fewer than 3
    associated poses."""
    from ..io import trajectory as tio

    t_e, r_e, p_e = tio.read_tum(est_path)
    t_g, r_g, p_g = tio.read_tum(gt_path)
    idx = np.clip(np.searchsorted(t_g, t_e), 0, len(t_g) - 1)
    ok = np.abs(t_g[idx] - t_e) < MAX_DT
    if ok.sum() < 3:
        return {"error": "fewer than 3 associated poses"}
    p_est, p_gt = p_e[ok], p_g[idx[ok]]
    a = ate(p_est, p_gt, align=align)
    rpe_t, rpe_r = rpe(r_e[ok], p_est, r_g[idx[ok]], p_gt)
    a_se3 = ate(p_est, p_gt, align="se3")
    a_sim3 = ate(p_est, p_gt, align="sim3")
    return {
        "n": a.n, "ate_rmse": a.rmse, "ate_rmse_se3": a_se3.rmse, "ate_rmse_sim3": a_sim3.rmse,
        "scale": a_sim3.scale, "scale_error": abs(a_sim3.scale - 1.0), "ate_mean": a.mean,
        "ate_median": a.median, "ate_max": a.max, "rpe_trans_rmse": rpe_t,
        "rpe_rot_rmse_deg": rpe_r, "align": align,
    }
