"""Appearance-based loop closure and relocalization.

Counterpart of ``vio360_tpu/loop/closure.py`` without its megastep
parts. Per keyframe: ring descriptor and feature patches
(loop/descriptor.py), ingest into the fixed-capacity place database on
the device, circular-correlation retrieval over all entries, NCC patch
matching against the top ``verify_top_k`` candidates, and geometric
verification of all of them by ONE batched PnP (kernel K1 with B =
verify_top_k problems, the reference's ``vmap`` of ``solve_pnp``); the
candidate with the most chi2 inliers among the PnP successes wins, and
its loop edge and rigid world correction come back in one packed record.
The host gates the record, appends a ``loop`` edge to the pose-graph
store and applies the correction to the live window and map.
``LoopCloser.capture_state`` / ``restore_state`` carry the database and
its ring bookkeeping through a checkpoint.
Relocalization runs the same retrieval and verification over the whole
database, each PnP seeded at its candidate's stored pose, and re-seeds
the map with the matched landmarks (marginalized, so they pin scale).

Candidate order follows ``jax.lax.top_k``: a stable descending sort, so
equal scores (masked entries all score -2) keep the lowest index first.
Unlike the reference's immutable arrays, the database is updated in
place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import VioConfig
from ..estimator import window as window_mod
from ..geometry import lie
from ..solver import pnp as pnp_mod
from . import descriptor as desc_mod


@dataclasses.dataclass
class LoopDb:
    """Fixed-capacity device-resident place database (ring buffer)."""

    desc: torch.Tensor  # [N,2,B,L] ring descriptors
    patches: torch.Tensor  # [N,C,P] normalized feature patches
    uv: torch.Tensor  # [N,C,2] feature pixel coords
    lm_pos: torch.Tensor  # [N,C,3] landmark world positions (slot-aligned)
    lm_ok: torch.Tensor  # [N,C] landmark validity
    pose_r: torch.Tensor  # [N,3,3] keyframe pose at ingest
    pose_t: torch.Tensor  # [N,3]

    @property
    def capacity(self) -> int:
        return self.desc.shape[0]


def empty_db(cfg: VioConfig, device=None) -> LoopDb:
    lcfg = cfg.loop
    n, c = lcfg.db_capacity, cfg.features.capacity
    p = lcfg.patch_size * lcfg.patch_size
    return LoopDb(
        desc=torch.zeros(n, 2, lcfg.desc_bands, lcfg.desc_bins, device=device),
        patches=torch.zeros(n, c, p, device=device),
        uv=torch.zeros(n, c, 2, device=device),
        lm_pos=torch.zeros(n, c, 3, device=device),
        lm_ok=torch.zeros(n, c, dtype=torch.bool, device=device),
        pose_r=torch.eye(3, device=device).repeat(n, 1, 1),
        pose_t=torch.zeros(n, 3, device=device),
    )


def _yaw_only(r: torch.Tensor) -> torch.Tensor:
    """Frobenius-closest rotation about +z (the gravity axis)."""
    th = torch.atan2(r[1, 0] - r[0, 1], r[0, 0] + r[1, 1])
    c, s = torch.cos(th), torch.sin(th)
    zero, one = torch.zeros_like(th), torch.ones_like(th)
    return torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]),
                        torch.stack([zero, zero, one])])


def unpack_record(rec) -> dict:
    """Host-side unpack of the record of ``retrieve_and_verify``: score,
    cand, shift, n_match, pnp_ok, n_inliers, pnp_cost, rel_r (9), rel_t (3),
    corr_r (9), corr_t (3)."""
    rec = np.asarray(rec)
    return {
        "score": float(rec[0]), "cand": int(rec[1]), "shift": int(rec[2]),
        "n_match": int(rec[3]), "pnp_ok": bool(rec[4] > 0.5), "n_inliers": int(rec[5]),
        "pnp_cost": float(rec[6]), "rel_r": rec[7:16].reshape(3, 3).copy(),
        "rel_t": rec[16:19].copy(), "corr_r": rec[19:28].reshape(3, 3).copy(),
        "corr_t": rec[28:31].copy(),
    }


def describe(image, uv, valid, cfg: VioConfig):
    """(ring descriptor, feature patches) of a frame."""
    lcfg = cfg.loop
    return (desc_mod.ring_descriptor(image, lcfg.desc_bands, lcfg.desc_bins),
            desc_mod.extract_patches(image, uv, valid, lcfg.patch_size, lcfg.patch_pyr_levels))


def _describe_and_join(image, uv, ids, valid, win, cfg: VioConfig):
    desc, patches = describe(image, uv, valid, cfg)
    lm_idx = window_mod.slot_to_landmark(win, torch.where(valid, ids, torch.full_like(ids, -1)))
    lm_pos = win.lm_pos[torch.clamp(lm_idx, 0, win.max_lm - 1).long()]
    return desc, patches, lm_pos, valid & (lm_idx >= 0)


def _ingest(db: LoopDb, write_idx: int, desc, patches, uv, lm_pos, lm_ok, r_kf, t_kf) -> None:
    """Write one entry at ring slot ``write_idx`` (in place)."""
    for name, v in (("desc", desc), ("patches", patches), ("uv", uv), ("lm_pos", lm_pos),
                    ("lm_ok", lm_ok), ("pose_r", r_kf), ("pose_t", t_kf)):
        getattr(db, name)[write_idx] = v


def retrieve_and_verify(db: LoopDb, desc, patches, uv, valid, qmask, seed_from_cand: bool, r_kf,
                        t_kf, r_cb, t_cb, cfg: VioConfig, yaw_only: bool):
    """Retrieval + geometric verification over the top-K candidates
    (``_retrieve_and_verify_cam``): each candidate is patch-matched and
    all K are PnP-verified in one batched K1 launch; the PnP success with
    the most inliers wins. Returns (record [31], (r_pnp, t_pnp),
    injection positions [C,3], injection validity [C])."""
    lcfg = cfg.loop
    k = min(lcfg.verify_top_k, db.capacity)
    scores, shifts = desc_mod.score_all_shifts(desc, db.desc)
    scores = torch.where(qmask, scores, torch.full_like(scores, -2.0))
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    top_s, top_i = top_s[:k], top_i[:k]

    match_idx, _ = desc_mod.match_patches(patches, valid, db.patches[top_i], db.lm_ok[top_i],
                                          lcfg.match_min_ncc, lcfg.match_min_margin)  # [K,C]
    safe_m = torch.clamp(match_idx, 0, match_idx.shape[-1] - 1).long()
    pts = db.lm_pos[top_i[:, None], safe_m]  # [K,C,3]
    active = (match_idx >= 0) & db.lm_ok[top_i[:, None], safe_m]
    if seed_from_cand:
        r_seed, t_seed = db.pose_r[top_i], db.pose_t[top_i]
    else:
        r_seed, t_seed = r_kf.expand(k, 3, 3), t_kf.expand(k, 3)
    res = pnp_mod.solve_pnp(
        r_seed, t_seed, pts, uv.expand(k, *uv.shape), active, torch.zeros_like(active), r_cb, t_cb,
        cfg.camera.width, cfg.camera.height, huber_delta=cfg.window.huber_delta,
        chi2_threshold=cfg.window.chi2_threshold, rounds=cfg.window.pnp_rounds,
        max_iterations=cfg.window.max_lm_iterations, min_inliers=lcfg.min_inliers,
    )
    n_match = active.sum(-1)
    inj_ok = active & res.success[:, None] & ~res.outlier

    quality = torch.where(res.success, res.num_inliers, torch.full_like(res.num_inliers, -1))
    b = desc_mod.first_argmax(quality, 0).long()
    cand = top_i[b]
    r_pnp, t_pnp = res.r_wb[b], res.t_wb[b]
    r_old, t_old = db.pose_r[cand], db.pose_t[cand]
    rel_r = r_old.T @ r_pnp
    rel_t = r_old.T @ (t_pnp - t_old)
    rc_full = r_pnp @ r_kf.T
    rc = _yaw_only(rc_full) if yaw_only else rc_full
    tc = t_pnp - rc @ t_kf
    f = lambda x: torch.as_tensor(x, device=scores.device).to(torch.float32).reshape(-1)
    record = torch.cat([
        f(top_s[b]), f(cand), f(shifts[cand]), f(n_match[b]), f(res.success[b]),
        f(res.num_inliers[b]), f(res.final_cost[b]), f(rel_r), f(rel_t), f(rc), f(tc),
    ])
    return record, (r_pnp, t_pnp), pts[b], inj_ok[b]


def apply_world_correction(win, r_c, t_c, r_cur, t_cur, r_prev, t_prev, vel):
    """Left-multiply the live window, map and current pose by the rigid
    world correction (x' = R_c x + t_c); the history stays in the old frame
    (the pose-graph solve reconciles it at export)."""
    kf_ok = win.kf_id >= 0
    kf_r2 = torch.einsum("ij,kjl->kil", r_c, win.kf_r)
    kf_t2 = torch.einsum("ij,kj->ki", r_c, win.kf_t) + t_c
    vel2 = torch.einsum("ij,kj->ki", r_c, win.kf_vel)
    lm2 = win.lm_pos @ r_c.T + t_c
    win = dataclasses.replace(
        win, kf_r=torch.where(kf_ok[:, None, None], kf_r2, win.kf_r),
        kf_t=torch.where(kf_ok[:, None], kf_t2, win.kf_t),
        kf_vel=torch.where(kf_ok[:, None], vel2, win.kf_vel),
        lm_pos=torch.where(win.lm_alive[:, None], lm2, win.lm_pos),
    )
    return (win, lie.so3_renormalize(r_c @ r_cur), r_c @ t_cur + t_c,
            lie.so3_renormalize(r_c @ r_prev), r_c @ t_prev + t_c, r_c @ vel)


def inject_landmarks(win, pos, ok, feat_ids, ref_kf_id):
    """Re-seed the map after relocalization: landmark slots for the matched
    database landmarks, linked to the current tracker ids and marginalized
    so BA keeps the recovered scale anchored to the old map."""
    win = window_mod.add_landmarks(win, pos, ok & ~(window_mod.slot_to_landmark(win, feat_ids) >= 0),
                                   feat_ids, ref_kf_id)
    # add_landmarks clears marg at the new slots: re-pin them by id join
    lm_new = win.lm_alive & torch.isin(win.lm_feat_id,
                                       torch.where(ok, feat_ids, torch.full_like(feat_ids, -3)))
    return dataclasses.replace(win, lm_marg=win.lm_marg | lm_new)


def transform_db(db: LoopDb, r_gw, s, t_anchor) -> LoopDb:
    """The world rotation + scale about the anchor of
    ``Estimator._transform_history``, on the stored landmarks and poses."""

    def xp(p):
        return t_anchor + (p @ r_gw.T - t_anchor) * s

    return dataclasses.replace(
        db, lm_pos=xp(db.lm_pos.reshape(-1, 3)).reshape(db.lm_pos.shape),
        pose_r=torch.einsum("ij,kjl->kil", r_gw, db.pose_r), pose_t=xp(db.pose_t))


class LoopCloser:
    """Host orchestration: ring-buffer bookkeeping, record gating and the
    loop edges; the device work is the functions above."""

    def __init__(self, cfg: VioConfig, device=None):
        self.cfg = cfg
        self.db = empty_db(cfg, device)
        n = cfg.loop.db_capacity
        self.entry_fid = np.full(n, -1, np.int64)
        self.entry_seq = np.full(n, -1, np.int64)
        self.seq = 0
        self._last_correction_seq = -(10 ** 9)

    def _write_idx(self) -> int:
        return self.seq % self.cfg.loop.db_capacity

    def _query_mask(self, exclude_recent: int) -> np.ndarray:
        """Entries old enough to be loop candidates (not the sliding
        window's own recent past)."""
        return (self.entry_seq >= 0) & (self.entry_seq <= self.seq - exclude_recent)

    @property
    def n_entries(self) -> int:
        return int((self.entry_seq >= 0).sum())

    def queryable(self) -> bool:
        return bool(self._query_mask(self.cfg.loop.exclude_recent_kf).any())

    def on_keyframe(self, image, uv, ids, valid, win, r_kf, t_kf, r_cb, t_cb, fid: int,
                    yaw_only: bool):
        """Ingest the new keyframe; when the database holds queryable
        entries, also retrieve + verify and return the gated result dict
        (or None)."""
        lcfg = self.cfg.loop
        w = self._write_idx()
        qm = self._query_mask(lcfg.exclude_recent_kf) if self.queryable() else None
        desc, patches, lm_pos, lm_ok = _describe_and_join(image, uv, ids, valid, win, self.cfg)
        _ingest(self.db, w, desc, patches, uv, lm_pos, lm_ok, r_kf, t_kf)
        out = None
        if qm is not None:
            # after the ring wraps, this frame's ingest overwrote slot w,
            # which the host still maps to the OLD frame: no self-match
            qm[w] = False
            rec, *_ = retrieve_and_verify(
                self.db, desc, patches, uv, valid, torch.as_tensor(qm, device=desc.device), False,
                r_kf, t_kf, r_cb, t_cb, self.cfg, yaw_only)
            out = self._gate(unpack_record(rec.cpu().numpy()), fid)
        self.entry_fid[w] = fid
        self.entry_seq[w] = self.seq
        self.seq += 1
        return out

    def _gate(self, rec: dict, fid: int):
        lcfg = self.cfg.loop
        if (rec["score"] < lcfg.min_score or rec["n_match"] < lcfg.min_matches
                or not rec["pnp_ok"] or rec["n_inliers"] < lcfg.min_inliers):
            return None
        # a "loop" implying an enormous jump is a mismatch, not a correction
        ang = np.degrees(np.arccos(np.clip((np.trace(rec["corr_r"]) - 1.0) / 2.0, -1.0, 1.0)))
        tmag = float(np.linalg.norm(rec["corr_t"]))
        if ang > lcfg.max_rot_correction_deg or tmag > lcfg.max_trans_correction:
            return None
        old_fid = int(self.entry_fid[rec["cand"]])
        if old_fid < 0 or old_fid == fid:
            return None
        # below the floors the edge still counts at export, but the live
        # window is only corrected for large, strongly verified,
        # rate-limited closures
        apply = ((tmag >= lcfg.min_trans_correction or ang >= lcfg.min_rot_correction_deg)
                 and rec["n_inliers"] >= lcfg.apply_inlier_factor * lcfg.min_inliers
                 and self.seq - self._last_correction_seq >= lcfg.correction_cooldown_kf)
        if apply:
            self._last_correction_seq = self.seq
        return {**rec, "old_fid": old_fid, "cur_fid": fid, "apply_correction": apply}

    def relocalize(self, image, uv, ids, valid, r_cb, t_cb):
        """Whole-database retrieval + PnP seeded at each candidate's pose.
        Returns (result dict | None, r, t, inj_pos, inj_ok); the tensors are
        meaningful only with a result."""
        qm = self.entry_seq >= 0
        if not qm.any():
            return None, None, None, None, None
        dev = self.db.desc.device
        desc, patches = describe(image, uv, valid, self.cfg)
        rec_t, (r_b, t_b), inj_pos, inj_ok = retrieve_and_verify(
            self.db, desc, patches, uv, valid, torch.as_tensor(qm, device=dev), True,
            torch.eye(3, device=dev), torch.zeros(3, device=dev), r_cb, t_cb, self.cfg, False)
        rec = unpack_record(rec_t.cpu().numpy())
        lcfg = self.cfg.loop
        if (rec["score"] < lcfg.reloc_min_score or rec["n_match"] < lcfg.min_matches
                or not rec["pnp_ok"] or rec["n_inliers"] < lcfg.min_inliers):
            return None, None, None, None, None
        rec["old_fid"] = int(self.entry_fid[rec["cand"]])
        return rec, r_b, t_b, inj_pos, inj_ok

    def transform(self, r_gw, s, t_anchor):
        """Keep the database in the live map's world frame
        (``Estimator._transform_history``)."""
        dev = self.db.desc.device
        self.db = transform_db(self.db, torch.as_tensor(np.asarray(r_gw), dtype=torch.float32, device=dev),
                               float(s), torch.as_tensor(np.asarray(t_anchor), dtype=torch.float32,
                                                         device=dev))

    def capture_state(self) -> dict:
        """The database and its ring bookkeeping (the JAX package's keys),
        sharing no storage with the live state."""
        from ..io.checkpoint import copy_tree

        return {"db": copy_tree(self.db), "entry_fid": self.entry_fid.copy(),
                "entry_seq": self.entry_seq.copy(), "seq": self.seq,
                "last_correction_seq": self._last_correction_seq}

    def restore_state(self, state: dict, copy: bool = True) -> None:
        """Set a state of ``capture_state``; ``copy=False`` takes over the
        leaves of a state that nothing else holds (``Estimator.load``)."""
        from ..io.checkpoint import copy_tree

        self.db = copy_tree(state["db"], self.db.desc.device, copy)
        self.entry_fid, self.entry_seq = (
            copy_tree(np.asarray(state[k], np.int64), None, copy) for k in ("entry_fid", "entry_seq"))
        self.seq = int(state["seq"])
        self._last_correction_seq = int(state["last_correction_seq"])
