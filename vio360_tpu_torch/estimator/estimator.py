"""Per-frame monocular VO state machine (sequential).

Counterpart of the VO-sequential subset of
``vio360_tpu/estimator/estimator.py``: ``process_frame`` (bootstrap,
two-view init with its window BA and per-frame PnP backfill, steady
tracking frames, keyframe events) and ``export_trajectory``. The IMU,
megastep, pipelined/batched loops, loop closure, pose graph and
checkpoints are not ported yet; the constructor refuses configurations
that need them. Every numeric stage runs on ``self.device``; the host
reads one small record per frame.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from vio360_tpu.config import VioConfig
from vio360_tpu.utils.logging import StageTimer, get_logger

from .. import device as device_mod
from ..frontend import tracker
from ..geometry import lie
from ..solver import pnp as pnp_mod
from . import fused, initializer, window

log = get_logger("vio360.torch.estimator")


@dataclasses.dataclass
class FrameResult:
    frame_id: int
    timestamp: float
    state: str  # "bootstrapping" | "initialized" | "tracking" | "tracking_lost"
    r_wb: np.ndarray
    t_wb: np.ndarray
    is_keyframe: bool
    n_tracked: int
    n_pnp_inliers: int
    diag: dict[str, Any]


def unported_features(cfg: VioConfig) -> list[str]:
    """Configuration switches that need a part of the system not ported yet."""
    out = []
    if cfg.loop.enabled:
        out.append("loop closure (loop.enabled)")
    if cfg.pose_graph.enabled:
        out.append("the pose graph (pose_graph.enabled)")
    if cfg.solver.mesh:
        out.append("the distributed window solve (solver.mesh)")
    if cfg.solver.frames_per_dispatch > 1:
        out.append("batched dispatch (solver.frames_per_dispatch > 1)")
    if not cfg.solver.fused_keyframe:
        out.append("the staged keyframe path (solver.fused_keyframe = False)")
    return out


class Estimator:
    """Stateful facade: ``process_frame(image, timestamp)`` per frame."""

    def __init__(self, cfg: VioConfig, device: str | torch.device | None = None, seed: int = 0):
        missing = unported_features(cfg)
        if missing:
            raise NotImplementedError("not ported yet: " + ", ".join(missing))
        device_mod.pin_fp32()
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        dev = self.device
        self.capacity = cfg.features.capacity
        self.track = tracker.init_state(self.capacity, dev)
        self.win = window.empty_window(cfg.window.max_keyframes, cfg.window.max_landmarks,
                                       self.capacity, dev)
        self.t_bc = torch.as_tensor(cfg.t_bc_array(), device=dev)
        self.r_bc = self.t_bc[:3, :3]
        self.r_cb = self.r_bc.T
        self.t_cb = -(self.r_bc.T @ self.t_bc[:3, 3])
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.initialized = False
        self.frame_id = -1
        self.img_prev: torch.Tensor | None = None  # packed frame buffer
        self.snapshots: list[dict[str, Any]] = []
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        self.r_cur, self.t_cur, self.r_prev, self.t_prev = eye, zero, eye, zero
        self.vel_cur = zero
        self.trajectory: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.kf_pose_log: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.traj_rel: list[tuple[int, np.ndarray, np.ndarray] | None] = []
        self.last_kf_fid = -1
        self.last_kf_capture: tuple[np.ndarray, np.ndarray] | None = None
        self.n_kf_host = 0
        self.timers = StageTimer()

    @contextlib.contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers.add(name, time.perf_counter() - t0)

    def _upload(self, image, timestamp) -> torch.Tensor:
        cfg = self.cfg
        buf = fused.pack_frame_input(
            np.asarray(image, np.float32), timestamp, None, cfg.imu.max_samples_per_frame,
            cfg.camera.width, frame_id=self.frame_id, transport=cfg.solver.image_transport,
        )
        return fused.to_device(buf, self.device)

    def _snapshot(self, timestamp: float) -> dict[str, Any]:
        t = self.track
        return {
            "uv": t.uv, "ids": torch.where(t.valid, t.ids, torch.full_like(t.ids, -1)),
            "valid": t.valid, "track_count": t.track_count, "time": timestamp,
            "frame_id": self.frame_id,
        }

    def _record(self, timestamp: float, r: np.ndarray | None = None, p: np.ndarray | None = None):
        if r is None:
            r, p = self.r_cur.cpu().numpy(), self.t_cur.cpu().numpy()
        self.trajectory.append((timestamp, r, p))
        if self.last_kf_capture is not None:
            kr, kp = self.last_kf_capture
            self.traj_rel.append((self.last_kf_fid, kr.T @ r, kr.T @ (p - kp)))
        else:
            self.traj_rel.append(None)

    def _log_window_poses(self):
        n = self.n_kf_host
        kf_id = self.win.kf_id[:n].cpu().numpy()
        kf_r = self.win.kf_r[:n].cpu().numpy()
        kf_t = self.win.kf_t[:n].cpu().numpy()
        for i in range(n):
            if kf_id[i] >= 0:
                self.kf_pose_log[int(kf_id[i])] = (kf_r[i], kf_t[i])
        return kf_id, kf_r, kf_t

    def _result(self, timestamp, state, is_kf, n_tracked, n_inl, diag, r=None, t=None):
        if r is None:
            r, t = self.r_cur.cpu().numpy(), self.t_cur.cpu().numpy()
        return FrameResult(self.frame_id, timestamp, state, np.asarray(r), np.asarray(t), is_kf,
                           n_tracked, n_inl, diag)

    # ------------------------------------------------------------------

    def process_frame(self, image, timestamp: float, imu: np.ndarray | None = None) -> FrameResult:
        if imu is not None and len(imu):
            raise NotImplementedError("not ported yet: visual-inertial odometry (IMU rows)")
        self.frame_id += 1
        cfg = self.cfg
        h = cfg.camera.height
        ts = torch.tensor(timestamp, dtype=torch.float32, device=self.device)
        if self.img_prev is None:
            buf = self._upload(image, timestamp)
            with self._stage("frontend"):
                self.track = tracker.bootstrap_frame(self.track, fused.buf_image(buf, h), ts, cfg)
            self.img_prev = buf
            self.snapshots = [self._snapshot(timestamp)]
            self._record(timestamp)
            return self._result(timestamp, "bootstrapping", False, 0, 0, {})
        if not self.initialized:
            buf = self._upload(image, timestamp)
            with self._stage("frontend"):
                self.track, _, tdiag = tracker.track_frame(
                    self.track, fused.buf_image(self.img_prev, h), fused.buf_image(buf, h), ts,
                    self.gen, cfg,
                )
            self.img_prev = buf
            return self._bootstrap_step(timestamp, int(tdiag["n_tracked"]))
        return self._tracking_step(image, timestamp)

    def _bootstrap_step(self, timestamp, n_tracked) -> FrameResult:
        cfg = self.cfg
        self.snapshots.append(self._snapshot(timestamp))
        if len(self.snapshots) > cfg.init.window_size:
            self.snapshots.pop(0)
        if len(self.snapshots) == cfg.init.window_size:
            first, last = self.snapshots[0], self.snapshots[-1]
            tracked_full = last["valid"] & (last["ids"] >= 0) & (last["ids"] == first["ids"])
            with self._stage("init"):
                res = initializer.try_initialize(
                    self.gen, first["uv"], last["uv"], tracked_full, last["track_count"] + 1,
                    self.t_bc, cfg,
                )
                outcome = torch.stack([res.success.float(), res.median_parallax.float(),
                                       res.scale_factor.float(), res.num_valid_points.float()]).cpu()
            if bool(outcome[0]):
                self._seed_from_init(first, last, res)
                self._backfill_bootstrap_poses(res)
                self._record(timestamp)
                diag = {"median_parallax": float(outcome[1]), "scale_factor": float(outcome[2])}
                return self._result(timestamp, "initialized", True, n_tracked, int(outcome[3]), diag)
        self._record(timestamp)
        return self._result(timestamp, "bootstrapping", False, n_tracked, 0, {})

    def _seed_from_init(self, first, last, res: initializer.InitResult):
        cfg = self.cfg
        dev = self.device
        zeros = torch.zeros(3, device=dev)
        self.win = window.add_keyframe(self.win, torch.eye(3, device=dev), zeros, zeros, zeros,
                                       zeros, first["time"], first["frame_id"], first["uv"],
                                       first["ids"])
        self.win = window.add_keyframe(self.win, res.r_wb2, res.t_wb2, zeros, zeros, zeros,
                                       last["time"], last["frame_id"], last["uv"], last["ids"])
        self.n_kf_host = 2
        self.win = window.add_landmarks(self.win, res.points_w, res.point_valid, last["ids"],
                                        self.win.kf_id[0])
        with self._stage("ba"):
            self.win, ba_res = window.window_ba(
                self.win, self.t_bc, cfg.camera.width, cfg.camera.height,
                cfg.camera.boundary_margin, huber_delta=cfg.window.huber_delta,
                chi2_threshold=cfg.window.chi2_threshold,
                max_iterations=cfg.window.max_lm_iterations,
            )
        i_last = self.n_kf_host - 1
        self.r_cur, self.t_cur = self.win.kf_r[i_last], self.win.kf_t[i_last]
        self.r_prev, self.t_prev = self.r_cur, self.t_cur
        self.initialized = True
        self.last_kf_fid = int(last["frame_id"])
        _, kf_r_h, kf_t_h = self._log_window_poses()
        self.last_kf_capture = (kf_r_h[i_last], kf_t_h[i_last])
        costs = torch.stack([ba_res.initial_cost, ba_res.final_cost]).cpu()
        log.info("Init success: %d landmarks, BA cost %.2f -> %.2f",
                 int(res.num_valid_points), float(costs[0]), float(costs[1]))

    def _backfill_bootstrap_poses(self, res: initializer.InitResult) -> None:
        """Interpolate the bootstrap window's intermediate poses between the
        two seeded keyframes, refine each by PnP against the fresh map,
        and anchor them to the second keyframe for export."""
        cfg = self.cfg
        w, h = cfg.camera.width, cfg.camera.height
        snaps = self.snapshots
        if len(snaps) < 3:
            return
        dev = self.device
        r_n, t_n = res.r_wb2.cpu().numpy(), res.t_wb2.cpu().numpy()
        t_first, t_last = snaps[0]["time"], snaps[-1]["time"]
        anchor_fid = int(snaps[-1]["frame_id"])
        for s in snaps[1:-1]:
            alpha = (s["time"] - t_first) / max(t_last - t_first, 1e-9)
            r_i, t_i = lie.interpolate_pose(torch.eye(3, device=dev), torch.zeros(3, device=dev),
                                            res.r_wb2, res.t_wb2, alpha)
            points, active, marg = fused._pnp_inputs(self.win, s["ids"], s["valid"], s["uv"], w, h,
                                                     cfg.camera.boundary_margin)
            with self._stage("pnp"):
                pr = pnp_mod.solve_pnp(
                    r_i, t_i, points, s["uv"], active, marg, self.r_cb, self.t_cb, w, h,
                    rounds=cfg.window.pnp_rounds, max_iterations=cfg.window.max_lm_iterations,
                    min_inliers=cfg.window.pnp_min_inliers,
                )
            r_i = torch.where(pr.success, pr.r_wb, r_i)
            t_i = torch.where(pr.success, pr.t_wb, t_i)
            fid = int(s["frame_id"])
            if not 0 <= fid < len(self.trajectory):
                continue
            r_np, t_np = r_i.cpu().numpy(), t_i.cpu().numpy()
            self.trajectory[fid] = (float(s["time"]), r_np, t_np)
            self.traj_rel[fid] = (anchor_fid, r_n.T @ r_np, r_n.T @ (t_np - t_n))

    def _tracking_step(self, image, timestamp) -> FrameResult:
        cfg = self.cfg
        buf = self._upload(image, timestamp)
        with self._stage("tracking_step"):
            self.track, r_new, t_new, v_new, bundle = fused.tracking_step(
                self.track, self.win, self.img_prev, buf, self.gen, self.r_cur, self.t_cur,
                self.r_prev, self.t_prev, self.vel_cur, self.r_bc, self.r_cb, self.t_cb, cfg,
            )
            b = fused.unpack_bundle(bundle.cpu().numpy())
        self.img_prev = buf
        self.r_prev, self.t_prev = self.r_cur, self.t_cur
        self.r_cur, self.t_cur, self.vel_cur = r_new, t_new, v_new
        diag = {"pnp_cost": b["pnp_cost"], "parallax": b["parallax"],
                "n_shared": b["n_shared"], "n_active": b["n_active"]}
        r_np, t_np = b["r"], b["t"]
        if b["is_kf"]:
            r_np, t_np = self._create_keyframe(timestamp, diag)
        self._record(timestamp, r_np, t_np)
        return FrameResult(self.frame_id, timestamp, "tracking" if b["success"] else "tracking_lost",
                           np.asarray(r_np), np.asarray(t_np), b["is_kf"], b["n_tracked"],
                           b["n_inliers"], diag)

    def _create_keyframe(self, timestamp, diag):
        """The keyframe event (fused.keyframe_step) + host bookkeeping."""
        cfg = self.cfg
        max_kf = cfg.window.max_keyframes
        with self._stage("keyframe_step"):
            self.track, self.win, self.r_cur, self.t_cur, self.vel_cur, record = fused.keyframe_step(
                cfg, self.track, self.win, float(timestamp), self.frame_id, self.r_cur, self.t_cur,
                self.vel_cur, self.t_bc,
            )
            rec = fused.unpack_kf_record(record.cpu().numpy(), max_kf)
        self.n_kf_host = min(self.n_kf_host + 1, max_kf)
        i_last = self.n_kf_host - 1
        for i in range(self.n_kf_host):
            fid = int(rec["kf_id"][i])
            if fid >= 0:
                self.kf_pose_log[fid] = (rec["kf_r"][i], rec["kf_t"][i])
        self.last_kf_fid = self.frame_id
        self.last_kf_capture = (rec["kf_r"][i_last], rec["kf_t"][i_last])
        if rec["n_dropped"]:
            log.warning("landmark slots saturated: dropped %d new landmarks (capacity %d)",
                        rec["n_dropped"], self.win.max_lm)
        diag.update(n_new_landmarks=rec["n_new"], n_lm_dropped=rec["n_dropped"],
                    n_lm_alive=rec["n_lm_alive"], n_lm_marginalized=rec["n_lm_marg"],
                    ba_cost=rec["ba_cost"], ba_inliers=rec["ba_inliers"])
        return rec["kf_r"][i_last], rec["kf_t"][i_last]

    def export_trajectory(self):
        """Trajectory with keyframes at their latest BA-refined poses and
        non-keyframes re-derived from their reference keyframe."""
        ts = np.asarray([t for t, _, _ in self.trajectory])
        rs = np.stack([r for _, r, _ in self.trajectory]) if self.trajectory else np.zeros((0, 3, 3))
        ps = np.stack([p for _, _, p in self.trajectory]) if self.trajectory else np.zeros((0, 3))
        for i, rel in enumerate(self.traj_rel):
            if rel is None:
                continue
            kf_fid, rel_r, rel_p = rel
            refined = self.kf_pose_log.get(kf_fid)
            if refined is not None:
                kr, kp = refined
                rs[i] = kr @ rel_r
                ps[i] = kp + kr @ rel_p
        for fid, (r, p) in self.kf_pose_log.items():
            if 0 <= fid < len(ts):
                rs[fid] = r
                ps[fid] = p
        return ts, rs, ps
