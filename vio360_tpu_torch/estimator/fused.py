"""The steady-state tracking frame and the keyframe event (VO and VIO).

Counterpart of ``vio360_tpu/estimator/fused.py``: the packed frame
buffer (with the same u8/u16/f32 image quantization, so the first frame
already matches the reference), ``tracking_step`` with constant-velocity
or IMU prediction, the keyframe decision, and the keyframe event
(``_kf_event_body``): window append, the keyframe-pair preintegration
with roll on eviction, window BA or VIBA, bias re-linearization, the
gated scale / gravity refine, outlier relabel and triangulation, with
the eviction capture for the pose graph. The JAX module fused each into
one compiled dispatch; here they are plain functions whose device work
is the hand-written kernels (LK, PnP, window BA) plus PyTorch ops, and
the host reads one small record per frame.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..config import VioConfig
from ..frontend import tracker
from ..geometry import camera as cam_g
from ..geometry import lie
from ..imu import preintegration as pre
from ..solver import imu_init as imu_init_mod
from ..solver import marginals
from ..solver import pnp as pnp_mod
from . import initializer, window


def _no_stage(name: str):
    return contextlib.nullcontext()


def _median_parallax(uv_now, ids_now, valid_now, kf_uv, kf_ids, width):
    """Median pixel displacement of features shared with a keyframe snapshot."""
    shared = valid_now & (ids_now >= 0) & (ids_now == kf_ids)
    du = cam_g.wrap_residual_u(uv_now[:, 0] - kf_uv[:, 0], width)
    dv = uv_now[:, 1] - kf_uv[:, 1]
    return initializer.masked_median(torch.sqrt(du * du + dv * dv), shared), shared.sum()


def _pnp_inputs(win: window.WindowState, ids, valid, uv, width, height, margin):
    """Slot-aligned PnP arrays: landmark positions + masks per feature slot."""
    lm_idx = window.slot_to_landmark(win, ids)
    has = lm_idx >= 0
    safe = torch.clamp(lm_idx, 0, win.max_lm - 1).to(torch.int64)
    points = win.lm_pos[safe]
    active = valid & has & ~cam_g.is_near_boundary(uv, width, height, margin)
    return points, active, win.lm_marg[safe] & has


def _relabel_tracks(track: tracker.TrackState, mask) -> tracker.TrackState:
    """Give outlier-latched slots a fresh feature id (breaks their join to
    the old landmark and to pre-latch keyframe snapshots)."""
    mask = mask & track.valid
    fresh = (track.next_id + torch.cumsum(mask.to(torch.int32), 0) - 1).to(torch.int32)
    return dataclasses.replace(
        track, ids=torch.where(mask, fresh, track.ids),
        next_id=(track.next_id + mask.sum()).to(torch.int32),
    )


def keyframe_decision(pnp_success, parallax, n_inl, n_active, cfg: VioConfig):
    """Parallax trigger OR (default-on) starving trigger, under PnP success."""
    parallax_kf = parallax >= cfg.tracking.min_parallax_for_keyframe
    ratio = cfg.tracking.kf_min_inlier_ratio
    if ratio > 0:
        starving = ((n_inl < ratio * torch.clamp(n_active, min=1))
                    & (n_inl >= 3 * cfg.window.pnp_min_inliers))
    else:
        starving = torch.zeros((), dtype=torch.bool, device=parallax.device)
    return pnp_success & (parallax_kf | starving)


def _predict_cv(r_cur, t_cur, r_prev, t_prev):
    """Constant-velocity pose prediction, snapped back onto SO(3)."""
    ri, ti = lie.se3_inverse(r_prev, t_prev)
    dr, dt = lie.se3_compose(ri, ti, r_cur, t_cur)
    r_pred, t_pred = lie.se3_compose(r_cur, t_cur, dr, dt)
    return lie.so3_renormalize(r_pred), t_pred


#: wire dtype + intensity scale per image-transport mode
_TRANSPORTS = {"f32": (None, 1.0), "u8": ("uint8", 255.0), "u16": ("uint16", 65535.0)}


def pack_frame_input(image, timestamp, imu_rows, cap: int, width: int, frame_id: int = 0,
                     transport: str = "f32") -> np.ndarray:
    """Host-side: one [H + aux_rows, W] buffer with the (quantized) image
    and the per-frame scalars (timestamp, frame id, IMU rows + mask)."""
    h, w = image.shape
    n_aux = 3 + cap * 8
    aux = np.zeros(n_aux, np.float32)
    aux[0] = timestamp
    aux[1] = frame_id
    n = min(len(imu_rows), cap) if imu_rows is not None else 0
    aux[2] = 1.0 if n else 0.0
    if n:
        aux[3:3 + n * 7] = np.asarray(imu_rows[-n:], np.float32).ravel()
        aux[3 + cap * 7:3 + cap * 7 + n] = 1.0
    dt_name, scale = _TRANSPORTS[transport]
    if dt_name is None:
        aux_rows = -(-n_aux // width)
        buf = np.zeros((h + aux_rows, w), np.float32)
        buf[:h] = image
        a = np.zeros(aux_rows * width, np.float32)
        a[:n_aux] = aux
        buf[h:] = a.reshape(aux_rows, width)
        return buf
    dt = np.dtype(dt_name)
    n_words = n_aux * (4 // dt.itemsize)
    aux_rows = -(-n_words // width)
    buf = np.zeros((h + aux_rows, w), dt)
    buf[:h] = np.rint(np.asarray(image, np.float32) * scale).clip(0, scale).astype(dt)
    a = np.zeros(aux_rows * width, dt)
    a[:n_words] = aux.view(dt)
    buf[h:] = a.reshape(aux_rows, width)
    return buf


def to_device(buf: np.ndarray, device) -> torch.Tensor:
    """Upload a packed buffer (uint16 travels as int16 bits: torch has no
    uint16 arithmetic)."""
    if buf.dtype == np.uint16:
        return torch.from_numpy(buf.view(np.int16)).to(device)
    return torch.from_numpy(buf).to(device)


def buf_image(frame_buf: torch.Tensor, height: int) -> torch.Tensor:
    """Image rows of a packed buffer as f32 in [0, 1], for any transport."""
    img = frame_buf[:height]
    if img.dtype == torch.uint8:
        return img.to(torch.float32) * (1.0 / 255.0)
    if img.dtype == torch.int16:
        return (img.to(torch.int32) & 0xFFFF).to(torch.float32) * (1.0 / 65535.0)
    return img


def unpack_frame_buf(frame_buf: torch.Tensor, cfg: VioConfig) -> dict:
    """Unpack pack_frame_input's layout (any transport)."""
    h = cfg.camera.height
    cap = cfg.imu.max_samples_per_frame
    n_aux = 3 + cap * 8
    if frame_buf.dtype == torch.float32:
        aux = frame_buf[h:].reshape(-1)
    else:
        lanes = 4 // frame_buf.element_size()
        aux = frame_buf[h:].reshape(-1)[:n_aux * lanes].contiguous().view(torch.float32)
    return {
        "img": buf_image(frame_buf, h),
        "timestamp": aux[0],
        "frame_id": aux[1].to(torch.int32),
        "have_imu": aux[2] > 0.5,
        "imu_samples": aux[3:3 + cap * 7].reshape(cap, 7),
        "imu_mask": aux[3 + cap * 7:3 + cap * 8] > 0.5,
    }


def tracking_step(track, win, prev_buf, frame_buf, gen: torch.Generator, r_cur, t_cur, r_prev,
                  t_prev, vel_cur, r_bc, r_cb, t_cb, cfg: VioConfig, bg=None, ba=None,
                  gravity_w=None, use_imu: bool = False, n_imu: int = 0, stage=_no_stage):
    """One tracking frame: pose prediction (constant velocity, or with
    ``use_imu`` the frame's ``n_imu`` IMU rows preintegrated and
    propagated) -> rotation-guess LK + RANSAC front end -> landmark join
    -> PnP -> outlier relabel -> keyframe decision. Returns (track',
    r_new, t_new, v_new, bundle [20]) with bundle laid out as in the
    reference (``unpack_bundle``). ``stage(name)`` times a sub-stage."""
    w, h = cfg.camera.width, cfg.camera.height
    fb = unpack_frame_buf(frame_buf, cfg)
    img_prev, img_next = buf_image(prev_buf, h), fb["img"]
    r_pred, t_pred = _predict_cv(r_cur, t_cur, r_prev, t_prev)
    v_pred = vel_cur
    if use_imu and n_imu:
        with stage("preintegration"):
            pf = pre.preintegrate_cfg(fb["imu_samples"][:n_imu], bg, ba, cfg.imu)
        r_pred, t_pred, v_pred = pre.predict_state(r_cur, t_cur, vel_cur, pf, gravity_w)
    r_cc_pred = None
    if cfg.optical_flow.use_rotation_guess:
        r_cc_pred = (r_pred @ r_bc).T @ (r_cur @ r_bc)
    track, _, tdiag = tracker.track_frame(track, img_prev, img_next, fb["timestamp"], gen, cfg,
                                          r_cc_pred=r_cc_pred, guess_from_imu=use_imu)

    ids = torch.where(track.valid, track.ids, torch.full_like(track.ids, -1))
    points, active, marg = _pnp_inputs(win, ids, track.valid, track.uv, w, h,
                                       cfg.camera.boundary_margin)
    res = pnp_mod.solve_pnp(
        r_pred, t_pred, points, track.uv, active, marg, r_cb, t_cb, w, h,
        huber_delta=cfg.window.huber_delta, chi2_threshold=cfg.window.chi2_threshold,
        rounds=cfg.window.pnp_rounds, max_iterations=cfg.window.max_lm_iterations,
        min_inliers=cfg.window.pnp_min_inliers,
    )
    track = _relabel_tracks(track, res.outlier & res.success)

    i_last = torch.clamp(win.n_kf - 1, 0, win.max_kf - 1).to(torch.int64)
    par, n_shared = _median_parallax(track.uv, ids, track.valid, win.kf_feat_uv[i_last],
                                     win.kf_feat_id[i_last], w)
    n_active = active.sum()
    is_kf = keyframe_decision(res.success, par, res.num_inliers, n_active, cfg)
    f = lambda x: x.to(torch.float32).reshape(-1)
    bundle = torch.cat([
        f(res.success), f(is_kf), f(res.num_inliers), f(tdiag["n_tracked"]), f(res.final_cost),
        f(par), f(n_shared), f(n_active), f(res.r_wb), f(res.t_wb),
    ])
    return track, res.r_wb, res.t_wb, v_pred, bundle


def unpack_bundle(b: np.ndarray) -> dict:
    """Host-side unpack of tracking_step's packed [20] record."""
    return {
        "success": bool(b[0]), "is_kf": bool(b[1]), "n_inliers": int(b[2]),
        "n_tracked": int(b[3]), "pnp_cost": float(b[4]), "parallax": float(b[5]),
        "n_shared": int(b[6]), "n_active": int(b[7]),
        "r": b[8:17].reshape(3, 3).copy(), "t": b[17:20].copy(),
    }


def _bad_slots(track, lm_slot, lm_feat_id, new_bad):
    """Tracker slots whose landmark BA just marked bad (id-joined)."""
    c = track.uv.shape[0]
    dest = torch.where(new_bad, torch.clamp(lm_slot, 0, c - 1), torch.full_like(lm_slot, c)).to(torch.int64)
    bad_id = tracker.scatter_drop(torch.full((c,), -2, dtype=torch.int32, device=lm_slot.device),
                                  dest, lm_feat_id)
    return track.ids == bad_id


def align_window(win: window.WindowState, r_wg, scale, velocities, applied=None):
    """The window's live keyframes (with ``velocities``) and landmarks in
    the gravity-aligned world rescaled about the first keyframe
    (``align_gravity_and_scale``); with ``applied`` (a device bool) only
    where it holds."""
    kf_r2, kf_t2, vel2, pts2 = imu_init_mod.align_gravity_and_scale(
        win.kf_r, win.kf_t, velocities, win.lm_pos, r_wg, scale)
    kf_ok, lm_ok = win.kf_id >= 0, win.lm_alive
    if applied is not None:
        kf_ok, lm_ok = kf_ok & applied, lm_ok & applied
    return dataclasses.replace(
        win, kf_r=torch.where(kf_ok[:, None, None], kf_r2, win.kf_r),
        kf_t=torch.where(kf_ok[:, None], kf_t2, win.kf_t),
        kf_vel=torch.where(kf_ok[:, None], vel2, win.kf_vel),
        lm_pos=torch.where(lm_ok[:, None], pts2, win.lm_pos),
    )


def imu_edge_parts(preints, bg, ba, kf_r0, kf_vel0, gravity_w) -> torch.Tensor:
    """[22]: the bias-corrected IMU odometry measurement of pair 0 for a
    pose-graph edge (``_imu_edge_parts``): dr (9), dp (3), dt (1), t_rel
    (3) and the rotation / position covariance diagonals (3 + 3)."""
    p0 = preints.map(lambda a: a[0])
    dbg, dba = bg - p0.bg, ba - p0.ba
    dr = p0.delta_r @ lie.so3_exp(p0.j_rg @ dbg)
    dp = p0.delta_p + p0.j_pg @ dbg + p0.j_pa @ dba
    dt = p0.dt_total
    t_rel = kf_r0.T @ (kf_vel0 * dt + 0.5 * gravity_w * dt * dt) + dp
    cov_d = torch.diagonal(p0.cov)
    return torch.cat([dr.reshape(9), dp, dt.reshape(1), t_rel, cov_d[0:3], cov_d[6:9]])


CAPTURE_LEN = 76  # eviction capture: kf_id (3), kf_r (27), kf_t (9), vel0 (3), pair_w (12), IMU edge (22)


def eviction_capture(cfg: VioConfig, win, r_cb, t_cb, imu_edge=None) -> torch.Tensor:
    """[CAPTURE_LEN] flat capture of the pre-eviction window for the
    pose-graph store: slots 0-2, the velocity of slot 0, the (0,1) and
    (0,2) sqrt-information when ``pose_graph.cov_weighted`` (else 0) and
    the IMU edge parts when given (else 0)."""
    dev = win.kf_r.device
    pair_w = (marginals.window_pair_sqrt_info(win, cfg, r_cb, t_cb) if cfg.pose_graph.cov_weighted
              else torch.zeros(2, 6, device=dev))
    if imu_edge is None:
        imu_edge = torch.zeros(22, device=dev)
    return torch.cat([win.kf_id[:3].to(torch.float32), win.kf_r[:3].reshape(27),
                      win.kf_t[:3].reshape(9), win.kf_vel[0], pair_w.reshape(12), imu_edge])


def unpack_capture(rec: np.ndarray) -> dict:
    """Host-side unpack of ``eviction_capture``."""
    e = rec[54:76]
    return {
        "cap_kf_id": rec[0:3].astype(np.int32), "cap_kf_r": rec[3:30].reshape(3, 3, 3).copy(),
        "cap_kf_t": rec[30:39].reshape(3, 3).copy(), "cap_vel0": rec[39:42].copy(),
        "pair_w": rec[42:54].reshape(2, 6).copy(),
        "imu_edge": {"dr": e[0:9].reshape(3, 3).copy(), "dp": e[9:12].copy(), "dt": float(e[12]),
                     "t_rel": e[13:16].copy(), "cov_r_diag": e[16:19].copy(),
                     "cov_p_diag": e[19:22].copy()},
    }


def keyframe_step(cfg: VioConfig, track, win, timestamp, frame_id, r_cur, t_cur, vel_cur, t_bc,
                  use_imu: bool = False, preints=None, n_pairs: int = 0, was_full: bool = False,
                  do_refine: bool = False, imu_rows=None, bg=None, ba=None, gravity_w=None,
                  capture: bool = False, stage=_no_stage):
    """The keyframe event (``_kf_event_body``): [``capture``: the eviction
    capture on the pre-eviction window] -> add_keyframe -> [VIO: the new
    pair's preintegration, rolled in on eviction] -> window BA or VIBA ->
    [VIO: bias re-linearization of every pair, the scale / gravity refine
    when ``do_refine`` and the solve passes its gates] -> outlier relabel
    -> triangulation -> packed record.

    Returns (track', win', preints', bg', ba', r', t', vel', record); the
    record has the reference's keyframe-record layout
    (``unpack_kf_record``). The reference computes the capture on every
    keyframe and its host reads it only when the window was full and the
    pose graph is on; here the caller asks for it only then (``capture``),
    and the record's capture fields are 0 otherwise."""
    dev = win.kf_r.device
    w, h = cfg.camera.width, cfg.camera.height
    wcfg, icfg = cfg.window, cfg.imu
    max_kf = wcfg.max_keyframes
    zeros = torch.zeros(3, device=dev)
    if bg is None:
        bg, ba = zeros, zeros
    cap = torch.zeros(CAPTURE_LEN, device=dev)
    if capture:
        with stage("pose_graph_capture"):
            r_bc, p_bc = t_bc[:3, :3], t_bc[:3, 3]
            imu_edge = (imu_edge_parts(preints, bg, ba, win.kf_r[0], win.kf_vel[0], gravity_w)
                        if use_imu else None)
            cap = eviction_capture(cfg, win, r_bc.T, -(r_bc.T @ p_bc), imu_edge)
    ids = torch.where(track.valid, track.ids, torch.full_like(track.ids, -1))
    win = window.add_keyframe(win, r_cur, t_cur, vel_cur, bg, ba, timestamp, frame_id, track.uv, ids)
    if use_imu:
        with stage("preintegration"):
            newp = pre.preintegrate_cfg(imu_rows, bg, ba, icfg)
        idx = max_kf - 2 if was_full else min(n_pairs, max_kf - 2)
        preints = pre.append(preints, newp, idx, was_full)
        pair_valid = pre.pair_valid_mask(preints, min(n_pairs + 1, max_kf - 1))
        with stage("viba"):
            win, res = window.window_viba(
                win, t_bc, preints, pair_valid, gravity_w, bg, ba, w, h, cfg.camera.boundary_margin,
                huber_delta=wcfg.huber_delta, chi2_threshold=wcfg.chi2_threshold,
                max_iterations=wcfg.viba_max_iterations, inertial_weight=wcfg.viba_inertial_weight,
                bg_prior_weight=wcfg.viba_bg_prior_weight, ba_prior_weight=wcfg.viba_ba_prior_weight,
            )
        bg, ba = res.bg, res.ba
        preints = pre.update_bias(preints, bg, ba)
    else:
        win, res = window.window_ba(
            win, t_bc, w, h, cfg.camera.boundary_margin, huber_delta=wcfg.huber_delta,
            chi2_threshold=wcfg.chi2_threshold, max_iterations=wcfg.max_lm_iterations,
        )

    # periodic scale / gravity refine (the host's do_refine flag + the
    # solution's sanity bounds; a refine that is not asked for changes
    # nothing, so it is not solved)
    applied = refine_s = r_wg = t_anchor = None
    if use_imu and do_refine:
        with stage("imu_init"):
            ri = imu_init_mod.solve_imu_init(win.kf_r, win.kf_t, preints, pair_valid,
                                             gravity_magnitude=icfg.gravity_magnitude)
        applied = ri.success & (ri.scale > 0.5) & (ri.scale < 2.0)
        refine_s = torch.where(applied, ri.scale, torch.ones_like(ri.scale))
        r_wg = torch.where(applied, imu_init_mod.gravity_dir_to_rotation(ri.gravity_dir),
                           torch.eye(3, device=dev))
        t_anchor = r_wg.T @ win.kf_t[0]  # the anchor before the alignment
        win = align_window(win, r_wg, refine_s, win.kf_vel, applied)

    track = _relabel_tracks(track, _bad_slots(track, win.lm_slot, win.lm_feat_id, res.new_bad))
    win, n_new, n_dropped = window.triangulate_new_landmarks(win, t_bc, w, h, live_ids=track.ids)
    i_last = torch.clamp(win.n_kf - 1, 0, max_kf - 1).to(torch.int64)
    vel_out = win.kf_vel[i_last] if use_imu else vel_cur
    record = kf_record(res, win, n_new, n_dropped, applied, refine_s, r_wg, t_anchor, cap)
    return track, win, preints, bg, ba, win.kf_r[i_last], win.kf_t[i_last], vel_out, record


def kf_record(res, win, n_new, n_dropped, applied=None, refine_s=None, r_wg=None, t_anchor=None,
              capture=None):
    """The keyframe event's flat f32 record (``unpack_kf_record``); the
    refine fields default to "not applied", the capture to 0."""
    dev = win.kf_r.device
    f = lambda x: torch.as_tensor(x, device=dev).to(torch.float32).reshape(-1)
    return torch.cat([
        f(res.final_cost), f(res.num_inliers), f(n_new), f(n_dropped), f(win.lm_alive.sum()),
        f((win.lm_marg & win.lm_alive).sum()), f(False if applied is None else applied),
        f(1.0 if refine_s is None else refine_s), f(torch.eye(3) if r_wg is None else r_wg),
        f(win.kf_t[0] if t_anchor is None else t_anchor), f(win.kf_id), f(win.kf_r), f(win.kf_t),
        torch.zeros(CAPTURE_LEN, device=dev) if capture is None else capture,
    ])


def kf_record_len(max_kf: int) -> int:
    """Flat length of the keyframe record (the reference's)."""
    return 20 + 13 * max_kf + CAPTURE_LEN


def unpack_kf_record(rec: np.ndarray, max_kf: int) -> dict:
    """Host-side unpack of keyframe_step's flat record."""
    k, o = max_kf, 20
    return {
        "ba_cost": float(rec[0]), "ba_inliers": int(rec[1]), "n_new": int(rec[2]),
        "n_dropped": int(rec[3]), "n_lm_alive": int(rec[4]), "n_lm_marg": int(rec[5]),
        "refine_applied": bool(rec[6] > 0.5), "refine_s": float(rec[7]),
        "r_wg": rec[8:17].reshape(3, 3).copy(), "t_anchor": rec[17:20].copy(),
        "kf_id": rec[o:o + k].astype(np.int32),
        "kf_r": rec[o + k:o + 10 * k].reshape(k, 3, 3).copy(),
        "kf_t": rec[o + 10 * k:o + 13 * k].reshape(k, 3).copy(),
        **unpack_capture(rec[o + 13 * k:]),
    }
