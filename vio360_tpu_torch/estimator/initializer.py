"""Monocular two-view bootstrap on bearing vectors.

Counterpart of ``vio360_tpu/estimator/initializer.py``: eligibility,
median-parallax gate, grid-uniform selection, 8-point essential RANSAC
+ refit, pose recovery by reprojection voting over the 4 candidates,
mid-point triangulation, validation, median-depth scale normalization,
body-pose seeding with T_BC (world := body1).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import VioConfig
from ..geometry import camera as cam
from ..geometry import essential as ess
from ..geometry import triangulation
from ..ops import ransac

_VOTE_REPROJ_THR = 5.0  # px


@dataclasses.dataclass
class InitResult:
    success: torch.Tensor
    r_21: torch.Tensor
    t_21: torch.Tensor
    r_wb2: torch.Tensor
    t_wb2: torch.Tensor
    points_w: torch.Tensor  # [C,3] slot-aligned
    point_valid: torch.Tensor  # [C]
    scale_factor: torch.Tensor
    median_parallax: torch.Tensor
    num_inliers: torch.Tensor
    num_valid_points: torch.Tensor


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over masked entries (mean of the two middle order stats for
    even counts); 0 when nothing is masked in."""
    big = torch.finfo(values.dtype).max
    v = torch.sort(torch.where(mask, values, torch.full_like(values, big))).values
    n = mask.sum()
    mid = n // 2
    lo = v[torch.clamp(mid - 1, min=0)]
    hi = v[torch.clamp(mid, 0, values.shape[0] - 1)]
    even = (n % 2 == 0) & (n > 0)
    med = torch.where(even, 0.5 * (lo + hi), hi)
    return torch.where(n > 0, med, torch.zeros_like(med))


def _select_grid(uv, eligible, obs_count, width, height, cols, rows, cap):
    """Keep <= cap per cell ranked by observation count (ties by slot)."""
    cx = torch.clamp((uv[:, 0] / (width / cols)).to(torch.int32), 0, cols - 1)
    cy = torch.clamp((uv[:, 1] / (height / rows)).to(torch.int32), 0, rows - 1)
    cell = cy * cols + cx
    same = (cell[:, None] == cell[None, :]) & eligible[None, :] & eligible[:, None]
    idx = torch.arange(uv.shape[0], device=uv.device)
    beats = (obs_count[None, :] > obs_count[:, None]) | (
        (obs_count[None, :] == obs_count[:, None]) & (idx[None, :] < idx[:, None])
    )
    return eligible & ((same & beats).sum(1) < cap)


def _reproj_err_px(p, bearing, width, height):
    uv_obs = cam.bearing_to_pixel(bearing, width, height)
    uv_prj = cam.bearing_to_pixel(p, width, height)
    du = cam.wrap_residual_u(uv_obs[..., 0] - uv_prj[..., 0], width)
    dv = uv_obs[..., 1] - uv_prj[..., 1]
    err = torch.sqrt(du * du + dv * dv)
    return torch.where(torch.linalg.norm(p, dim=-1) < 1e-6, torch.full_like(err, 1000.0), err)


def try_initialize(gen: torch.Generator, uv_first, uv_last, tracked_full_window, obs_count, t_bc,
                   cfg: VioConfig) -> InitResult:
    """Two-view init from the first and last frames of the bootstrap window."""
    c, icfg = cfg.camera, cfg.init
    w, h = c.width, c.height
    eligible = tracked_full_window & (obs_count >= icfg.min_observations)
    du = cam.wrap_residual_u(uv_last[:, 0] - uv_first[:, 0], w)
    dv = uv_last[:, 1] - uv_first[:, 1]
    med_par = masked_median(torch.sqrt(du * du + dv * dv), eligible)
    parallax_ok = med_par >= icfg.min_parallax
    enough = eligible.sum() >= icfg.min_features
    selected = _select_grid(uv_last, eligible, obs_count, w, h, icfg.grid_cols, icfg.grid_rows,
                            icfg.max_per_cell)
    b1 = cam.pixel_to_bearing(uv_first, w, h)
    b2 = cam.pixel_to_bearing(uv_last, w, h)
    e_mat, inlier, n_inl = ransac.essential_ransac(gen, b1, b2, selected, icfg.ransac_threshold,
                                                   icfg.ransac_iterations)
    e_ok = n_inl >= icfg.min_features

    rs, ts = ess.decompose_essential(e_mat)
    votes = []
    for i in range(4):
        pts, tri_ok = triangulation.triangulate_midpoint(b1, b2, rs[i], ts[i])
        e_ref = _reproj_err_px(pts, b1, w, h)
        e_cur = _reproj_err_px(pts @ rs[i].T + ts[i], b2, w, h)
        votes.append((inlier & tri_ok & (e_ref < _VOTE_REPROJ_THR) & (e_cur < _VOTE_REPROJ_THR)).sum())
    votes = torch.stack(votes)
    best = torch.argmax(votes)
    r_21, t_21 = rs[best], ts[best]
    pose_ok = votes[best] >= icfg.min_features

    pts_c1, tri_ok = triangulation.triangulate_midpoint(b1, b2, r_21, t_21)
    e_ref = _reproj_err_px(pts_c1, b1, w, h)
    e_cur = _reproj_err_px(pts_c1 @ r_21.T + t_21, b2, w, h)
    dist = torch.linalg.norm(pts_c1, dim=-1)
    point_valid = (inlier & tri_ok & (dist >= 1e-6) & (e_ref <= icfg.max_reprojection_error)
                   & (e_cur <= icfg.max_reprojection_error))
    n_valid = point_valid.sum()
    valid_ok = n_valid >= icfg.min_features

    med_depth = masked_median(dist, point_valid & (dist > 0.01))
    scale = torch.where(med_depth > 1e-9, 1.0 / med_depth, torch.ones_like(med_depth))
    pts_c1 = pts_c1 * scale
    t_21_s = t_21 * scale

    r_bc, p_bc = t_bc[:3, :3], t_bc[:3, 3]
    t_12 = -(r_21.T @ t_21_s)
    r_wc2 = r_bc @ r_21.T
    t_wc2 = r_bc @ t_12 + p_bc
    r_cb, p_cb = r_bc.T, -(r_bc.T @ p_bc)
    r_wb2 = r_wc2 @ r_cb
    t_wb2 = r_wc2 @ p_cb + t_wc2
    points_w = pts_c1 @ r_bc.T + p_bc

    success = parallax_ok & enough & e_ok & pose_ok & valid_ok
    point_valid = point_valid & success
    return InitResult(
        success=success, r_21=r_21, t_21=t_21_s, r_wb2=r_wb2, t_wb2=t_wb2,
        points_w=torch.where(point_valid[:, None], points_w, torch.zeros_like(points_w)),
        point_valid=point_valid, scale_factor=scale, median_parallax=med_par,
        num_inliers=n_inl, num_valid_points=n_valid,
    )
