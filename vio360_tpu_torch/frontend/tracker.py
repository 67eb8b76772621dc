"""Feature-track state machine as fixed-capacity tensors + masks.

Counterpart of ``vio360_tpu/frontend/tracker.py``: a feature lives at a
stable slot of ``[capacity]`` tensors from birth to death. JAX's
fixed-size ``nonzero`` and its dropping of out-of-range scatter indices
are reproduced on purpose (``ransac.compact_indices``, ``scatter_drop``)
so no step has a data-dependent shape or a host sync.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import VioConfig
from ..geometry import camera as cam
from ..ops import lk, ransac, shi_tomasi


@dataclasses.dataclass
class TrackState:
    uv: torch.Tensor  # [C, 2] current pixel positions
    prev_uv: torch.Tensor  # [C, 2] positions in previous frame
    vel: torch.Tensor  # [C, 2] px/s flow velocity
    ids: torch.Tensor  # [C] int32 unique feature ids (-1 = empty slot)
    age: torch.Tensor  # [C] int32
    track_count: torch.Tensor  # [C] int32 consecutive successful tracks
    valid: torch.Tensor  # [C] bool
    next_id: torch.Tensor  # [] int32
    last_time: torch.Tensor  # [] f32

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


def init_state(capacity: int, device=None) -> TrackState:
    z2 = torch.zeros(capacity, 2, device=device)
    zi = torch.zeros(capacity, dtype=torch.int32, device=device)
    return TrackState(
        uv=z2, prev_uv=z2.clone(), vel=z2.clone(),
        ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        age=zi, track_count=zi.clone(),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
        last_time=torch.zeros((), device=device),
    )


def scatter_drop(target: torch.Tensor, dest: torch.Tensor, values) -> torch.Tensor:
    """``target.at[dest].set(values, mode="drop")``: rows with dest ==
    len(target) land in a scratch row that is cut off. Where several rows
    share a destination the last one wins, as in the XLA CPU scatter the
    reference is tested on; the winner is picked explicitly, because on
    the card a plain index_put leaves it to the order its threads run in
    (a landmark join by tracker slot then depends on the run)."""
    ext = torch.cat([target, target[:1]], 0)
    n, k = ext.shape[0], dest.shape[0]
    dest = dest.to(torch.int64)
    order = torch.arange(k, device=dest.device)
    # rows bound for the scratch row get keys of their own, so that the
    # card's atomics do not pile up on one address
    key = torch.where(dest == n - 1, n + order, dest)
    last = torch.full((n + k,), -1, dtype=torch.int64, device=dest.device).scatter_reduce(
        0, key, order, reduce="amax")
    dest = torch.where(last[key] == order, dest, torch.full_like(dest, n - 1))
    ext[dest] = values if torch.is_tensor(values) else torch.as_tensor(values, dtype=ext.dtype, device=ext.device)
    return ext[:-1]


def _cell_index(uv, width, height, cols, rows):
    cx = torch.clamp((uv[:, 0] / (width / cols)).to(torch.int32), 0, cols - 1)
    cy = torch.clamp((uv[:, 1] / (height / rows)).to(torch.int32), 0, rows - 1)
    return (cy * cols + cx).to(torch.int64)


def _remove_clustered(uv, valid, width, height, cols, rows, std_ratio=0.25):
    """Invalidate features in cells whose position std is tiny (>= 4 per cell)."""
    n_cells = cols * rows
    cell = torch.where(valid, _cell_index(uv, width, height, cols, rows), torch.full_like(valid, n_cells, dtype=torch.int64))
    w = valid.float()

    def seg(x):
        return torch.zeros(n_cells + 1, device=uv.device).index_add_(0, cell, x)

    cnt, sx, sy = seg(w), seg(w * uv[:, 0]), seg(w * uv[:, 1])
    sxx, syy = seg(w * uv[:, 0] ** 2), seg(w * uv[:, 1] ** 2)
    safe = torch.clamp(cnt, min=1.0)
    var = (sxx + syy) / safe - (sx / safe) ** 2 - (sy / safe) ** 2
    std = torch.sqrt(torch.clamp(var, min=0.0))
    diag = math.sqrt((width / cols) ** 2 + (height / rows) ** 2)
    clustered = (cnt >= 4) & (std < std_ratio * diag)
    return valid & ~clustered[cell]


def _limit_per_cell(uv, valid, track_count, width, height, cols, rows, cap):
    """Keep at most ``cap`` features per grid cell, preferring higher
    track_count (ties by slot index)."""
    cell = _cell_index(uv, width, height, cols, rows)
    same_cell = (cell[:, None] == cell[None, :]) & valid[None, :] & valid[:, None]
    tc_i, tc_j = track_count[:, None], track_count[None, :]
    idx = torch.arange(uv.shape[0], device=uv.device)
    beats_me = (tc_j > tc_i) | ((tc_j == tc_i) & (idx[None, :] < idx[:, None]))
    return valid & ((same_cell & beats_me).sum(1) < cap)


def _row_gain_compensate(ref: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Per-row multiplicative gain matching ``img`` to ``ref`` (confidence-
    weighted, 9-row box-smoothed, clamped to [0.5, 2])."""
    rm, im = ref.mean(-1), img.mean(-1)
    g = rm / torch.clamp(im, min=1e-6)
    w = torch.clamp(im / 0.05, 0.0, 1.0)
    g = 1.0 + (g - 1.0) * w
    p = torch.cat([g[:1].expand(4), g, g[-1:].expand(4)])
    n = g.shape[0]
    g = sum(p[j:j + n] * (1.0 / 9.0) for j in range(9))
    return img * torch.clamp(g, 0.5, 2.0)[:, None]


def _rotation_guess(uv, r_cc, width, height):
    b_cur = cam.pixel_to_bearing(uv, width, height) @ r_cc.T
    return cam.bearing_to_pixel(b_cur, width, height)


def track_frame(state: TrackState, img_prev, img_next, timestamp, gen: torch.Generator,
                cfg: VioConfig, r_cc_pred=None, guess_from_imu: bool = False):
    """One front-end step. Returns (new_state, R_prev_to_curr, diag).

    ``r_cc_pred`` (prev-camera to cur-camera rotation) seeds LK with the
    rotation-predicted flow; ``guess_skips_top_level`` drops the top
    pyramid level only when that prediction comes from the gyro
    (``guess_from_imu``)."""
    c, f = cfg.camera, cfg.features
    of = cfg.optical_flow
    w, h = c.width, c.height
    dev = state.uv.device
    if of.photometric_compensation:
        img_next = _row_gain_compensate(img_prev, img_next)
    uv_guess = None
    num_levels = of.max_level
    if r_cc_pred is not None and of.use_rotation_guess:
        uv_guess = _rotation_guess(state.uv, r_cc_pred, w, h)
        if guess_from_imu and of.guess_skips_top_level and num_levels >= 2:
            num_levels -= 1

    # 1. LK track
    uv_new, status, err = lk.track(
        img_prev, img_next, state.uv, state.valid, uv_guess=uv_guess, num_levels=num_levels,
        half_win=of.window_size // 2, iters=of.max_iterations, eps=of.epsilon, backend=of.backend,
    )
    tracked = state.valid & status
    n_tracked = tracked.sum()

    # 2. polar / boundary rejection
    tracked &= ~cam.is_in_polar_region(uv_new, h, c.polar_exclusion_ratio)
    tracked &= ~cam.is_near_boundary(uv_new, w, h, c.boundary_margin)

    # 3. rotation-only RANSAC on bearings
    b_prev = cam.pixel_to_bearing(state.uv, w, h)
    b_curr = cam.pixel_to_bearing(uv_new, w, h)
    r_rel, inliers, n_inl = ransac.rotation_ransac(
        gen, b_prev, b_curr, tracked,
        threshold_rad=math.radians(cfg.ransac.threshold_degrees),
        iterations=cfg.ransac.max_iterations,
    )
    survived = tracked & inliers

    # 4. bookkeeping
    dt = torch.clamp(timestamp - state.last_time, min=1e-6)
    vel = (uv_new - state.uv) / dt
    vel = torch.stack([cam.wrap_residual_u(vel[:, 0] * dt, w) / dt, vel[:, 1]], -1)
    zero_i = torch.zeros_like(state.age)
    age = torch.where(survived, state.age + 1, zero_i)
    track_count = torch.where(survived, state.track_count + 1, zero_i)

    # 5. clustered-cell removal (gated on the visualization flag, as in the reference)
    if cfg.viz.highlight_clustered_grid:
        survived = _remove_clustered(uv_new, survived, w, h, f.grid_cols, f.grid_rows,
                                     std_ratio=cfg.viz.clustered_std_ratio)
    # 6. per-cell cap
    survived = _limit_per_cell(uv_new, survived, track_count, w, h, f.grid_cols, f.grid_rows,
                               f.max_features_per_grid)

    # 7. re-detect to top up max_features
    allowed = cam.polar_mask(w, h, c.polar_exclusion_ratio, device=dev)
    cand_uv, _, cand_valid = shi_tomasi.detect(
        img_next, allowed, uv_new, survived, max_new=f.capacity,
        min_distance=f.min_distance, quality_level=f.quality_level,
    )
    n_valid = survived.sum()
    budget = torch.clamp(f.max_features - n_valid, min=0)
    capacity = state.capacity
    free_slots = ransac.compact_indices(~survived, capacity)
    cand_rank = torch.cumsum(cand_valid.to(torch.int64), 0) - 1
    take = cand_valid & (cand_rank < budget) & (cand_rank < capacity)
    dest = torch.where(take, free_slots[torch.clamp(cand_rank, 0, capacity - 1)],
                       torch.full_like(cand_rank, capacity))

    uv = torch.where(survived[:, None], uv_new, state.uv)
    prev_uv = scatter_drop(torch.where(survived[:, None], state.uv, uv), dest, cand_uv)
    uv = scatter_drop(uv, dest, cand_uv)
    vel = scatter_drop(torch.where(survived[:, None], vel, torch.zeros_like(vel)), dest, 0.0)
    n_new = take.sum()
    new_ids = (state.next_id + torch.cumsum(take.to(torch.int32), 0) - 1).to(torch.int32)
    ids = scatter_drop(torch.where(survived, state.ids, torch.full_like(state.ids, -1)), dest, new_ids)
    age = scatter_drop(torch.where(survived, age, zero_i), dest, 0)
    track_count = scatter_drop(torch.where(survived, track_count, zero_i), dest, 0)
    new_valid = scatter_drop(survived, dest, True)

    new_state = TrackState(
        uv=uv, prev_uv=prev_uv, vel=vel, ids=ids, age=age, track_count=track_count,
        valid=new_valid, next_id=(state.next_id + n_new).to(torch.int32),
        last_time=torch.as_tensor(timestamp, dtype=torch.float32, device=dev),
    )
    diag = {
        "n_tracked": n_tracked,
        "n_ransac_inliers": n_inl,
        "n_survived": n_valid,
        "n_new": n_new,
        "mean_err": torch.where(survived, err, torch.zeros_like(err)).sum() / torch.clamp(n_valid, min=1),
    }
    return new_state, r_rel, diag


def bootstrap_frame(state: TrackState, img, timestamp, cfg: VioConfig) -> TrackState:
    """First-frame detection (no tracking)."""
    c, f = cfg.camera, cfg.features
    dev = state.uv.device
    allowed = cam.polar_mask(c.width, c.height, c.polar_exclusion_ratio, device=dev)
    cand_uv, _, cand_valid = shi_tomasi.detect(
        img, allowed, torch.zeros(1, 2, device=dev), torch.zeros(1, dtype=torch.bool, device=dev),
        max_new=f.capacity, min_distance=f.min_distance, quality_level=f.quality_level,
    )
    n = torch.clamp(cand_valid.sum(), max=f.max_features)
    idx = torch.arange(state.capacity, device=dev)
    valid = cand_valid & (idx < n)
    return TrackState(
        uv=cand_uv, prev_uv=cand_uv.clone(), vel=torch.zeros_like(state.vel),
        ids=torch.where(valid, idx, torch.full_like(idx, -1)).to(torch.int32),
        age=torch.zeros_like(state.age), track_count=torch.zeros_like(state.track_count),
        valid=valid, next_id=n.to(torch.int32),
        last_time=torch.as_tensor(timestamp, dtype=torch.float32, device=dev),
    )
