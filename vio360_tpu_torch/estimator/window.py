"""Sliding-window map state as fixed-capacity tensors.

Counterpart of ``vio360_tpu/estimator/window.py``: keyframes oldest-first
in ``[K]`` slots, each with a snapshot of the tracker slots; landmark
observations derived by an id-equality join; eviction re-references or
kills landmarks of the evicted keyframe. ``add_keyframe`` computes the
evicted window and selects it with ``torch.where``, so it needs no host
read of the keyframe count.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import camera as cam
from ..geometry import lie
from ..geometry import triangulation
from ..ops.ransac import compact_indices
from ..solver import ba as ba_mod
from ..solver import viba as viba_mod
from ..frontend.tracker import scatter_drop


@dataclasses.dataclass
class WindowState:
    kf_r: torch.Tensor  # [K,3,3]
    kf_t: torch.Tensor  # [K,3]
    kf_vel: torch.Tensor  # [K,3]
    kf_bg: torch.Tensor  # [K,3]
    kf_ba: torch.Tensor  # [K,3]
    kf_time: torch.Tensor  # [K]
    kf_id: torch.Tensor  # [K] i32 frame id (-1 = empty)
    kf_feat_uv: torch.Tensor  # [K,C,2]
    kf_feat_id: torch.Tensor  # [K,C] i32
    n_kf: torch.Tensor  # [] i32
    lm_pos: torch.Tensor  # [L,3]
    lm_alive: torch.Tensor  # [L] bool
    lm_marg: torch.Tensor  # [L] bool
    lm_slot: torch.Tensor  # [L] i32
    lm_feat_id: torch.Tensor  # [L] i32
    lm_ref_kf: torch.Tensor  # [L] i32

    @property
    def max_kf(self) -> int:
        return self.kf_r.shape[0]

    @property
    def max_lm(self) -> int:
        return self.lm_pos.shape[0]


def empty_window(max_kf: int, max_lm: int, capacity: int, device=None) -> WindowState:
    i32 = dict(dtype=torch.int32, device=device)
    return WindowState(
        kf_r=torch.eye(3, device=device).repeat(max_kf, 1, 1),
        kf_t=torch.zeros(max_kf, 3, device=device),
        kf_vel=torch.zeros(max_kf, 3, device=device),
        kf_bg=torch.zeros(max_kf, 3, device=device),
        kf_ba=torch.zeros(max_kf, 3, device=device),
        kf_time=torch.zeros(max_kf, device=device),
        kf_id=torch.full((max_kf,), -1, **i32),
        kf_feat_uv=torch.zeros(max_kf, capacity, 2, device=device),
        kf_feat_id=torch.full((max_kf, capacity), -1, **i32),
        n_kf=torch.zeros((), **i32),
        lm_pos=torch.zeros(max_lm, 3, device=device),
        lm_alive=torch.zeros(max_lm, dtype=torch.bool, device=device),
        lm_marg=torch.zeros(max_lm, dtype=torch.bool, device=device),
        lm_slot=torch.full((max_lm,), -1, **i32),
        lm_feat_id=torch.full((max_lm,), -1, **i32),
        lm_ref_kf=torch.full((max_lm,), -1, **i32),
    )


def observations(win: WindowState):
    """Dense incidence: (obs_uv [K,L,2], obs_mask [K,L])."""
    slot = torch.clamp(win.lm_slot, 0, win.kf_feat_uv.shape[1] - 1).to(torch.int64)
    uv = win.kf_feat_uv[:, slot, :]
    ids = win.kf_feat_id[:, slot]
    mask = ((win.kf_id >= 0)[:, None] & win.lm_alive[None, :] & (win.lm_feat_id[None, :] >= 0)
            & (ids == win.lm_feat_id[None, :]))
    return uv, mask


def slot_to_landmark(win: WindowState, feat_ids: torch.Tensor) -> torch.Tensor:
    """[C] feature ids -> landmark index per slot (-1 = none)."""
    c = feat_ids.shape[0]
    src = torch.where(win.lm_alive & (win.lm_feat_id >= 0), win.lm_slot,
                      torch.full_like(win.lm_slot, c)).to(torch.int64)
    lm_idx = torch.arange(win.max_lm, dtype=torch.int32, device=feat_ids.device)
    out = scatter_drop(torch.full((c,), -1, dtype=torch.int32, device=feat_ids.device), src, lm_idx)
    got = torch.where(out >= 0, win.lm_feat_id[torch.clamp(out, 0, win.max_lm - 1).to(torch.int64)],
                      torch.full_like(out, -2))
    return torch.where(got == feat_ids, out, torch.full_like(out, -1))


def _evict(w: WindowState) -> WindowState:
    k = w.max_kf
    _, mask = observations(w)
    obs_later = mask[1:].any(0)
    ref_evicted = w.lm_ref_kf == w.kf_id[0]
    first_obs = torch.argmax(mask[1:].to(torch.int32), 0) + 1
    new_ref = w.kf_id[torch.clamp(first_obs, 0, k - 1)]
    lm_ref = torch.where(ref_evicted & obs_later, new_ref, w.lm_ref_kf)
    lm_marg = w.lm_marg | (ref_evicted & obs_later & w.lm_alive)
    lm_alive = w.lm_alive & ~(ref_evicted & ~obs_later) & obs_later

    def shift(a):
        return torch.roll(a, -1, 0)

    kf_id = shift(w.kf_id).clone()
    kf_id[k - 1] = -1
    kf_feat_id = shift(w.kf_feat_id).clone()
    kf_feat_id[k - 1] = -1
    return dataclasses.replace(
        w, kf_r=shift(w.kf_r), kf_t=shift(w.kf_t), kf_vel=shift(w.kf_vel), kf_bg=shift(w.kf_bg),
        kf_ba=shift(w.kf_ba), kf_time=shift(w.kf_time), kf_id=kf_id,
        kf_feat_uv=shift(w.kf_feat_uv), kf_feat_id=kf_feat_id, n_kf=w.n_kf - 1,
        lm_ref_kf=lm_ref, lm_marg=lm_marg, lm_alive=lm_alive,
    )


def _select(cond: torch.Tensor, a: WindowState, b: WindowState) -> WindowState:
    out = {}
    for f in dataclasses.fields(WindowState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = torch.where(cond.reshape((1,) * x.dim()) if x.dim() else cond, x, y)
    return WindowState(**out)


def add_keyframe(win: WindowState, r_wb, t_wb, vel, bg, ba_bias, time, frame_id, feat_uv,
                 feat_ids) -> WindowState:
    """Append a keyframe, evicting the oldest if the window is full."""
    k = win.max_kf
    win = _select(win.n_kf >= k, _evict(win), win)
    idx = torch.clamp(win.n_kf, 0, k - 1).to(torch.int64)
    put = lambda a, v: a.index_put((idx[None],), torch.as_tensor(v, dtype=a.dtype, device=a.device)[None])
    return dataclasses.replace(
        win, kf_r=put(win.kf_r, r_wb), kf_t=put(win.kf_t, t_wb), kf_vel=put(win.kf_vel, vel),
        kf_bg=put(win.kf_bg, bg), kf_ba=put(win.kf_ba, ba_bias), kf_time=put(win.kf_time, time),
        kf_id=put(win.kf_id, frame_id), kf_feat_uv=put(win.kf_feat_uv, feat_uv),
        kf_feat_id=put(win.kf_feat_id, feat_ids), n_kf=win.n_kf + 1,
    )


def add_landmarks(win: WindowState, positions, new_valid, feat_ids, ref_kf_id) -> WindowState:
    """Allocate landmark slots for feature slots (slot-aligned input)."""
    l = win.max_lm
    free = compact_indices(~win.lm_alive, l)
    rank = torch.cumsum(new_valid.to(torch.int64), 0) - 1
    take = new_valid & (rank < (~win.lm_alive).sum())
    dest = torch.where(take, free[torch.clamp(rank, 0, l - 1)], torch.full_like(rank, l))
    slots = torch.arange(positions.shape[0], dtype=torch.int32, device=positions.device)
    ref = torch.as_tensor(ref_kf_id, dtype=torch.int32, device=positions.device).expand(positions.shape[0])
    return dataclasses.replace(
        win,
        lm_pos=scatter_drop(win.lm_pos, dest, positions.to(win.lm_pos.dtype)),
        lm_alive=scatter_drop(win.lm_alive, dest, True),
        lm_marg=scatter_drop(win.lm_marg, dest, False),
        lm_slot=scatter_drop(win.lm_slot, dest, slots),
        lm_feat_id=scatter_drop(win.lm_feat_id, dest, feat_ids.to(torch.int32)),
        lm_ref_kf=scatter_drop(win.lm_ref_kf, dest, ref),
    )


def triangulate_new_landmarks(win: WindowState, t_bc, width: int, height: int, live_ids=None):
    """DLT-triangulate features shared by the last two keyframes that have
    no landmark yet. Returns (window, n_new, n_dropped)."""
    k = win.max_kf
    i2 = torch.clamp(win.n_kf - 1, 0, k - 1).to(torch.int64)
    i1 = torch.clamp(win.n_kf - 2, 0, k - 1).to(torch.int64)
    ids1, ids2 = win.kf_feat_id[i1], win.kf_feat_id[i2]
    uv1, uv2 = win.kf_feat_uv[i1], win.kf_feat_uv[i2]
    shared = (ids1 >= 0) & (ids1 == ids2)
    cand = shared & ~(slot_to_landmark(win, ids2) >= 0) & (win.n_kf >= 2)
    if live_ids is not None:
        cand &= ids2 == live_ids
    r_bc, p_bc = t_bc[:3, :3], t_bc[:3, 3]
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=t_bc.device)

    def t_cw(r_wb, t_wb):
        r_wc = r_wb @ r_bc
        t_wc = r_wb @ p_bc + t_wb
        top = torch.cat([r_wc.T, (-(r_wc.T @ t_wc))[:, None]], 1)
        return torch.cat([top, bottom], 0)

    b1 = cam.pixel_to_bearing(uv1, width, height)
    b2 = cam.pixel_to_bearing(uv2, width, height)
    pts_w, tri_ok = triangulation.triangulate_dlt(
        b1, b2, t_cw(win.kf_r[i1], win.kf_t[i1]), t_cw(win.kf_r[i2], win.kf_t[i2]))
    new_valid = cand & tri_ok
    n_free = (~win.lm_alive).sum()
    n_want = new_valid.sum()
    n_dropped = torch.clamp(n_want - n_free, min=0)
    win = add_landmarks(win, pts_w, new_valid, ids2, win.kf_id[i1])
    return win, torch.minimum(n_want, n_free), n_dropped


def _window_problem(win: WindowState, t_bc, width: int, height: int, boundary_margin: float):
    """The window solve's inputs: boundary-filtered observations, the
    oldest keyframe and empty slots fixed, dead and marginalized
    landmarks fixed, and the body-to-camera extrinsics."""
    obs_uv, obs_mask = observations(win)
    obs_mask = obs_mask & ~cam.is_near_boundary(obs_uv, width, height, boundary_margin)
    kf_ok = win.kf_id >= 0
    fixed_pose = ~kf_ok | (torch.arange(win.max_kf, device=kf_ok.device) == 0)
    fixed_point = ~win.lm_alive | win.lm_marg
    r_bc, p_bc = t_bc[:3, :3], t_bc[:3, 3]
    return obs_uv, obs_mask, kf_ok, fixed_pose, fixed_point, r_bc.T, -(r_bc.T @ p_bc)


def _write_back(win: WindowState, kf_ok, res, **extra) -> WindowState:
    return dataclasses.replace(
        win,
        # renorm: window rotations survive many solves; keep them on SO(3)
        kf_r=torch.where(kf_ok[:, None, None], lie.so3_renormalize(res.r_wb), win.kf_r),
        kf_t=torch.where(kf_ok[:, None], res.t_wb, win.kf_t),
        lm_pos=torch.where((win.lm_alive & ~win.lm_marg)[:, None], res.points, win.lm_pos),
        lm_alive=win.lm_alive & ~res.new_bad, **extra,
    )


def window_ba(win: WindowState, t_bc, width: int, height: int, boundary_margin: float,
              huber_delta: float = 1.0, chi2_threshold: float = 5.991,
              max_iterations: int = 50):
    """Local BA over the window: fix the oldest keyframe + marginalized
    landmarks, boundary-filtered observations; write back poses/points
    and kill newly-bad landmarks."""
    obs_uv, obs_mask, kf_ok, fixed_pose, fixed_point, r_cb, t_cb = _window_problem(
        win, t_bc, width, height, boundary_margin)
    res = ba_mod.run_ba(
        win.kf_r, win.kf_t, win.lm_pos, obs_uv, obs_mask, fixed_pose, fixed_point, win.lm_marg,
        r_cb, t_cb, width, height, huber_delta=huber_delta, chi2_threshold=chi2_threshold,
        max_iterations=max_iterations,
    )
    return _write_back(win, kf_ok, res), res


def window_viba(win: WindowState, t_bc, preints, pair_valid, gravity_w, bg, ba_bias, width: int,
                height: int, boundary_margin: float, huber_delta: float = 1.0,
                chi2_threshold: float = 5.991, max_iterations: int = 20,
                inertial_weight: float = 1.0, bg_prior_weight: float = 50.0,
                ba_prior_weight: float = 50.0):
    """Visual-inertial local BA over the window: window_ba's gauge and
    outlier rules plus inertial factors between consecutive keyframes;
    writes back poses, velocities and points and kills newly-bad landmarks."""
    obs_uv, obs_mask, kf_ok, fixed_pose, fixed_point, r_cb, t_cb = _window_problem(
        win, t_bc, width, height, boundary_margin)
    res = viba_mod.run_viba(
        win.kf_r, win.kf_t, win.kf_vel, bg, ba_bias, win.lm_pos, obs_uv, obs_mask, fixed_pose,
        fixed_point, win.lm_marg, preints, pair_valid, gravity_w, r_cb, t_cb, width, height,
        huber_delta=huber_delta, chi2_threshold=chi2_threshold, max_iterations=max_iterations,
        inertial_weight=inertial_weight, bg_prior_weight=bg_prior_weight,
        ba_prior_weight=ba_prior_weight,
    )
    win = _write_back(win, kf_ok, res,
                      kf_vel=torch.where(kf_ok[:, None], res.vel, win.kf_vel))
    return win, res
