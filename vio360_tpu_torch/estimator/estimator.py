"""Per-frame VO / VIO state machine (sequential).

Counterpart of the sequential subset of
``vio360_tpu/estimator/estimator.py``: ``process_frame`` with its IMU
accounting (bootstrap, two-view init with its window BA, then either
the VO per-frame PnP backfill or the VIO promotion of the bootstrap
window to keyframes and the IMU initialization with its quality gates;
steady tracking frames with constant-velocity or IMU prediction;
keyframe events with window BA or VIBA, the IMU-init retry after a
rejection, and the periodic scale / gravity refine), the pose-graph
store (eviction edges with covariance weights, loop edges, the SE(3) or
Sim(3) solve at export), loop closure after every keyframe event,
relocalization after ``loop.reloc_after`` lost frames,
``export_trajectory``, the run lifecycle (``reset``, ``capture_state`` /
``restore_state``, ``save`` / ``load`` of either package's checkpoint) and
the async frame API (``process_frame_async`` / ``flush``). The megastep
and batched dispatch are not ported; the constructor refuses
configurations that need them. Every numeric stage runs on
``self.device``; the host reads small records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import Any

import numpy as np
import torch

from .. import device as device_mod
from ..config import VioConfig, fit_loop_config
from ..frontend import tracker
from ..geometry import lie
from ..imu import preintegration as pre
from ..io import checkpoint as ckpt
from ..loop import closure as loop_mod
from ..solver import imu_init as imu_init_mod
from ..solver import marginals
from ..solver import pnp as pnp_mod
from ..solver import pose_graph as pg_mod
from ..utils.logging import StageTimer, get_logger
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


@dataclasses.dataclass
class PgEdge:
    """One SE(3) relative constraint of the pose graph (``PgEdge`` of the
    reference). ``w_sqrt`` is the [6] diagonal sqrt-information (rho,
    phi). IMU edges keep what re-derives their translation under a world
    similarity transform (their dP and gravity terms are metric; only the
    v0 dt term follows the rescaled world)."""

    fi: int
    fj: int
    rel_r: np.ndarray  # [3,3]
    rel_t: np.ndarray  # [3]
    w_sqrt: np.ndarray  # [6]
    kind: str = "vis"  # "vis" | "skip" | "imu" | "loop"
    v0: np.ndarray | None = None  # IMU: world velocity of node i at record time
    r0: np.ndarray | None = None  # IMU: world rotation of node i at record time
    dt: float = 0.0  # IMU: preintegration span [s]
    dp: np.ndarray | None = None  # IMU: bias-corrected body-frame delta-p


def unported_features(cfg: VioConfig) -> list[str]:
    """Configuration switches that need a part of the system not ported yet."""
    out = []
    if cfg.solver.mesh:
        out.append("the distributed window solve (solver.mesh)")
    if cfg.solver.frames_per_dispatch > 1:
        out.append("batched dispatch (solver.frames_per_dispatch > 1)")
    if not cfg.solver.fused_keyframe:
        out.append("the staged keyframe path (solver.fused_keyframe = False)")
    return out


def generator_seed(words: np.ndarray) -> int:
    """A 63-bit generator seed from the bytes of a saved generator state
    or PRNG key: the first 8 bytes of their SHA-256, little-endian."""
    digest = hashlib.sha256(np.ascontiguousarray(words).tobytes()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _rows(imu) -> np.ndarray:
    return (np.asarray(imu, np.float64).reshape(-1, 7) if imu is not None and len(imu)
            else np.zeros((0, 7)))


class Estimator:
    """Stateful facade: ``process_frame(image, timestamp, imu)`` per frame.
    ``device=None`` means the card (``device.resolve``)."""

    # The complete mutable state: capture_state saves these attributes and
    # restore_state sets them, so that a resumed run equals an uninterrupted
    # one bit for bit (tests/test_torch_checkpoint.py holds this tuple and
    # _NOT_STATE against the attributes __init__ creates). ``gen`` is saved
    # as its generator state (on the card its Philox seed and offset), the
    # loop closer as its capture_state.
    _STATE = (
        "frame_id", "initialized", "gen", "track", "win", "img_prev", "snapshots",
        "r_cur", "t_cur", "r_prev", "t_prev", "vel_cur", "bg", "ba", "gravity_w",
        "imu_initialized", "has_imu_stream", "scale_refine_count", "preints", "n_pairs",
        "imu_since_last_kf", "last_imu_rows", "trajectory", "traj_rel", "kf_pose_log",
        "last_kf_fid", "last_kf_capture", "n_kf_host", "lost_streak", "pg_nodes", "pg_edges",
        "loop_closer", "_last_kf_window_host",
    )
    # Not state: the configuration (with its fit_loop_config result) and
    # what __init__ derives from it, the per-keyframe Sim(3) scales (filled
    # by the export's pose-graph solve) and the stage timers.
    _NOT_STATE = ("cfg", "device", "seed", "capacity", "t_bc", "r_bc", "r_cb", "t_cb",
                  "kf_scale_log", "timers")

    def __init__(self, cfg: VioConfig, device: str | torch.device | None = None, seed: int = 0):
        missing = unported_features(cfg)
        if missing:
            raise NotImplementedError("not ported yet: " + ", ".join(missing))
        device_mod.pin_fp32()
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.seed = seed
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
        self.trajectory: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.kf_pose_log: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.traj_rel: list[tuple[int, np.ndarray, np.ndarray] | None] = []
        self.last_kf_fid = -1
        self.last_kf_capture: tuple[np.ndarray, np.ndarray] | None = None
        self.n_kf_host = 0
        # ---- inertial state ----
        self.imu_initialized = False
        self.has_imu_stream = False
        self.scale_refine_count = 0
        self.vel_cur = zero
        self.bg, self.ba = zero, zero
        self.gravity_w = torch.tensor([0.0, 0.0, -cfg.imu.gravity_magnitude], device=dev)
        self.imu_since_last_kf: list[np.ndarray] = []
        self.last_imu_rows = np.zeros((0, 7))
        self.preints = pre.stack([pre.identity_preintegration(dev)] * (cfg.window.max_keyframes - 1))
        self.n_pairs = 0  # live keyframe-pair count
        # ---- pose-graph store: evicted keyframes (eviction order) and edges ----
        self.pg_nodes: list[int] = []
        self.pg_edges: list[PgEdge] = []
        # per-keyframe local scale from the Sim(3) solve (export only)
        self.kf_scale_log: dict[int, float] = {}
        # ---- loop closure + relocalization ----
        self.loop_closer = None
        self.lost_streak = 0
        self._last_kf_window_host = None  # (kf_id, kf_r, kf_t) of the last keyframe event
        if cfg.loop.enabled:
            fitted = fit_loop_config(cfg.loop, cfg.camera)
            if fitted is not cfg.loop:
                self.cfg = cfg = dataclasses.replace(cfg, loop=fitted)
            self.loop_closer = loop_mod.LoopCloser(cfg, dev)
        self.timers = StageTimer()

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Wall time of a stage; on the card it ends in a synchronize so
        that the time is the stage's and not its enqueue."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timers.add(name, time.perf_counter() - t0)

    def _upload(self, image, timestamp, imu_rows=None) -> torch.Tensor:
        cfg = self.cfg
        buf = fused.pack_frame_input(
            np.asarray(image, np.float32), timestamp, imu_rows, cfg.imu.max_samples_per_frame,
            cfg.camera.width, frame_id=self.frame_id, transport=cfg.solver.image_transport,
        )
        return fused.to_device(buf, self.device)

    def _snapshot(self, timestamp: float, imu_rows: np.ndarray) -> dict[str, Any]:
        t = self.track
        return {
            "uv": t.uv, "ids": torch.where(t.valid, t.ids, torch.full_like(t.ids, -1)),
            "valid": t.valid, "track_count": t.track_count, "time": timestamp,
            "frame_id": self.frame_id, "imu": imu_rows,
        }

    def _preintegrate(self, rows: np.ndarray, bg, ba, cap: int) -> pre.Preintegration:
        """Preintegration of the last ``cap`` host IMU rows (as f32)."""
        n = min(len(rows), cap)
        s = torch.as_tensor(np.asarray(rows[len(rows) - n:], np.float32).reshape(n, 7),
                            device=self.device)
        with self._stage("preintegration"):
            return pre.preintegrate_cfg(s, bg, ba, self.cfg.imu)

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

    def _pnp_refine(self, s, r_i, t_i):
        """PnP of a bootstrap snapshot against the current map from (r_i, t_i)."""
        cfg = self.cfg
        points, active, marg = fused._pnp_inputs(self.win, s["ids"], s["valid"], s["uv"],
                                                 cfg.camera.width, cfg.camera.height,
                                                 cfg.camera.boundary_margin)
        with self._stage("pnp"):
            pr = pnp_mod.solve_pnp(
                r_i, t_i, points, s["uv"], active, marg, self.r_cb, self.t_cb, cfg.camera.width,
                cfg.camera.height, rounds=cfg.window.pnp_rounds,
                max_iterations=cfg.window.max_lm_iterations, min_inliers=cfg.window.pnp_min_inliers,
            )
        return torch.where(pr.success, pr.r_wb, r_i), torch.where(pr.success, pr.t_wb, t_i)

    def _window_ba(self):
        cfg = self.cfg
        with self._stage("ba"):
            self.win, res = window.window_ba(
                self.win, self.t_bc, cfg.camera.width, cfg.camera.height,
                cfg.camera.boundary_margin, huber_delta=cfg.window.huber_delta,
                chi2_threshold=cfg.window.chi2_threshold,
                max_iterations=cfg.window.max_lm_iterations,
            )
        return res

    # ------------------------------------------------------------------

    def process_frame(self, image, timestamp: float, imu: np.ndarray | None = None) -> FrameResult:
        self.frame_id += 1
        cfg = self.cfg
        imu_rows = _rows(imu)
        if len(imu_rows):
            self.imu_since_last_kf.append(imu_rows)
            self.has_imu_stream = True
        self.last_imu_rows = imu_rows
        h = cfg.camera.height
        ts = torch.tensor(timestamp, dtype=torch.float32, device=self.device)
        if self.img_prev is None:
            buf = self._upload(image, timestamp)
            with self._stage("frontend"):
                self.track = tracker.bootstrap_frame(self.track, fused.buf_image(buf, h), ts, cfg)
            self.img_prev = buf
            self.snapshots = [self._snapshot(timestamp, imu_rows)]
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
            return self._bootstrap_step(timestamp, int(tdiag["n_tracked"]), imu_rows)
        return self._tracking_step(image, timestamp)

    def _bootstrap_step(self, timestamp, n_tracked, imu_rows) -> FrameResult:
        cfg = self.cfg
        self.snapshots.append(self._snapshot(timestamp, imu_rows))
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
                diag = {"median_parallax": float(outcome[1]), "scale_factor": float(outcome[2])}
                if any(len(s["imu"]) for s in self.snapshots):
                    # VIO: every window frame becomes a keyframe, then IMU init
                    self._promote_window_frames(res)
                    diag["imu_initialized"] = self._try_initialize_imu()
                else:
                    self._backfill_bootstrap_poses(res)
                self._record(timestamp)
                return self._result(timestamp, "initialized", True, n_tracked, int(outcome[3]), diag)
        self._record(timestamp)
        return self._result(timestamp, "bootstrapping", False, n_tracked, 0, {})

    def _seed_from_init(self, first, last, res: initializer.InitResult):
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
        ba_res = self._window_ba()
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
        """VO: interpolate the bootstrap window's intermediate poses between
        the two seeded keyframes, refine each by PnP against the fresh
        map, and anchor them to the second keyframe for export."""
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
            r_i, t_i = self._pnp_refine(s, r_i, t_i)
            fid = int(s["frame_id"])
            if not 0 <= fid < len(self.trajectory):
                continue
            r_np, t_np = r_i.cpu().numpy(), t_i.cpu().numpy()
            self.trajectory[fid] = (float(s["time"]), r_np, t_np)
            self.traj_rel[fid] = (anchor_fid, r_n.T @ r_np, r_n.T @ (t_np - t_n))

    def _promote_window_frames(self, res: initializer.InitResult):
        """VIO: rebuild the window from every bootstrap frame (interpolated
        poses refined by PnP), with one preintegration per frame pair."""
        cfg = self.cfg
        dev = self.device
        snaps = self.snapshots[-cfg.window.max_keyframes:]
        n = len(snaps)
        zeros = torch.zeros(3, device=dev)
        r0, t0v = torch.eye(3, device=dev), zeros
        t_first, t_last = snaps[0]["time"], snaps[-1]["time"]
        self.win = window.empty_window(cfg.window.max_keyframes, cfg.window.max_landmarks,
                                       self.capacity, dev)
        self.win = window.add_keyframe(self.win, r0, t0v, zeros, zeros, zeros, t_first,
                                       snaps[0]["frame_id"], snaps[0]["uv"], snaps[0]["ids"])
        self.win = window.add_landmarks(self.win, res.points_w, res.point_valid, snaps[-1]["ids"],
                                        self.win.kf_id[0])
        pres = []
        for i in range(1, n):
            s = snaps[i]
            if i == n - 1:
                r_i, t_i = res.r_wb2, res.t_wb2
            else:
                alpha = (s["time"] - t_first) / max(t_last - t_first, 1e-9)
                r_i, t_i = self._pnp_refine(s, *lie.interpolate_pose(r0, t0v, res.r_wb2, res.t_wb2,
                                                                      alpha))
            self.win = window.add_keyframe(self.win, r_i, t_i, zeros, zeros, zeros, s["time"],
                                           s["frame_id"], s["uv"], s["ids"])
            pres.append(self._preintegrate(s["imu"], self.bg, self.ba,
                                           cfg.imu.max_samples_per_frame))
        self.n_kf_host = min(n, cfg.window.max_keyframes)
        self._set_preints(pres)
        self._window_ba()
        i_last = self.n_kf_host - 1
        self.r_cur, self.t_cur = self.win.kf_r[i_last], self.win.kf_t[i_last]
        self.r_prev, self.t_prev = self.r_cur, self.t_cur
        self.imu_since_last_kf = []
        self.last_kf_fid = int(snaps[-1]["frame_id"])
        _, kf_r_h, kf_t_h = self._log_window_poses()
        self.last_kf_capture = (kf_r_h[i_last], kf_t_h[i_last])

    def _set_preints(self, pres: list) -> None:
        n_max = self.cfg.window.max_keyframes - 1
        pres = list(pres[:n_max])
        self.n_pairs = len(pres)
        pres += [pre.identity_preintegration(self.device)] * (n_max - len(pres))
        self.preints = pre.stack(pres)

    def _solve_imu_init(self, pair_valid):
        return imu_init_mod.solve_imu_init(self.win.kf_r, self.win.kf_t, self.preints, pair_valid,
                                           gravity_magnitude=self.cfg.imu.gravity_magnitude)

    def _try_initialize_imu(self) -> bool:
        """Gravity / scale / velocities / biases from the window, behind
        two quality gates: the stage-1 cost per pair, and (with >= 4
        pairs) agreement of the gravity solved on each half of the window."""
        cfg = self.cfg
        k = self.n_kf_host
        if k < 3 or self.n_pairs != k - 1:
            return False
        with self._stage("imu_init"):
            pair_valid = pre.pair_valid_mask(self.preints, self.n_pairs)
            res = self._solve_imu_init(pair_valid)
            n_pairs = max(self.n_pairs, 1)
            use_split = (n_pairs // 2) >= 2
            split_deg = 0.0
            if use_split:
                half = torch.arange(cfg.window.max_keyframes - 1, device=self.device) < n_pairs // 2
                res_a = self._solve_imu_init(pair_valid & half)
                res_b = self._solve_imu_init(pair_valid & ~half)
                split_deg = np.inf
                if bool(res_a.success) and bool(res_b.success):
                    g_a, g_b = res_a.gravity_w.cpu().numpy(), res_b.gravity_w.cpu().numpy()
                    ca = float(np.dot(g_a, g_b) / max(np.linalg.norm(g_a) * np.linalg.norm(g_b), 1e-9))
                    split_deg = float(np.degrees(np.arccos(np.clip(ca, -1.0, 1.0))))
            ok, cost1, scale = bool(res.success), float(res.stage1_cost), float(res.scale)
        per_pair = cost1 / n_pairs
        if (not ok or per_pair > cfg.imu.init_max_cost_per_pair
                or split_deg > cfg.imu.init_max_gravity_split_deg):
            log.info("IMU init rejected (cost1=%.3g/pair %.3g, gravity split %.1f deg)", cost1,
                     per_pair, split_deg)
            return False
        r_wg = imu_init_mod.gravity_dir_to_rotation(res.gravity_dir)
        self._transform_history(r_wg, scale)
        self.win = fused.align_window(self.win, r_wg, res.scale, res.velocities)
        self.bg, self.ba = res.bg, res.ba
        self.gravity_w = torch.tensor([0.0, 0.0, -cfg.imu.gravity_magnitude], device=self.device)
        self.preints = pre.update_bias(self.preints, self.bg, self.ba)
        i_last = self.n_kf_host - 1
        self.r_cur, self.t_cur = self.win.kf_r[i_last], self.win.kf_t[i_last]
        self.r_prev, self.t_prev = self.r_cur, self.t_cur
        self.vel_cur = self.win.kf_vel[i_last]
        self.imu_initialized = True
        _, kf_r_h, kf_t_h = self._log_window_poses()
        if self.last_kf_capture is not None:
            self.last_kf_capture = (kf_r_h[i_last], kf_t_h[i_last])
        g = res.gravity_w.cpu().numpy()
        log.info("IMU init: scale=%.4f g=(%.2f,%.2f,%.2f) bg=%s", scale, *[float(x) for x in g],
                 np.round(res.bg.cpu().numpy(), 4))
        return True

    # ------------------------------------------------------------------
    # Pose graph
    # ------------------------------------------------------------------

    def _record_pose_graph_eviction(self) -> None:
        """Staged eviction capture (the keyframe path outside
        fused.keyframe_step): edges for window slot 0 from the current
        window, before add_keyframe rolls it out."""
        imu_edge = None
        if self.imu_initialized and self.n_pairs > 0:
            imu_edge = fused.imu_edge_parts(self.preints, self.bg, self.ba, self.win.kf_r[0],
                                            self.win.kf_vel[0], self.gravity_w)
        with self._stage("pose_graph_capture"):
            cap = fused.unpack_capture(fused.eviction_capture(
                self.cfg, self.win, self.r_cb, self.t_cb, imu_edge).cpu().numpy())
        self._append_pg_edges_host(cap, imu_edge is not None)

    def _append_pg_edges_host(self, cap: dict, use_imu: bool) -> None:
        """Eviction capture (``fused.unpack_capture`` fields) -> PgEdge
        records: the consecutive (0,1) edge, the (0,2) skip edge and, with
        the IMU, the preintegration odometry edge of pair 0."""
        pcfg = self.cfg.pose_graph
        kf_id, kf_r, kf_t = cap["cap_kf_id"], cap["cap_kf_r"], cap["cap_kf_t"]
        fid0 = int(kf_id[0])
        if fid0 < 0:
            return
        self.pg_nodes.append(fid0)

        def fallback(wt, wr):
            return np.concatenate([np.full(3, wt), np.full(3, wr)]).astype(np.float32)

        if pcfg.cov_weighted:
            w01, w02 = np.asarray(cap["pair_w"])
        else:
            w01 = fallback(pcfg.vis_weight_t, pcfg.vis_weight_r)
            w02 = fallback(pcfg.skip_weight_t, pcfg.skip_weight_r)

        def rel(i, j):
            return (np.asarray(kf_r[i].T @ kf_r[j], np.float32),
                    np.asarray(kf_r[i].T @ (kf_t[j] - kf_t[i]), np.float32))

        self.pg_edges.append(PgEdge(fid0, int(kf_id[1]), *rel(0, 1), w01, "vis"))
        if int(kf_id[2]) >= 0:
            self.pg_edges.append(PgEdge(fid0, int(kf_id[2]), *rel(0, 2), w02, "skip"))
        e = cap["imu_edge"]
        if use_imu and e["dt"] > 1e-6:
            if pcfg.cov_weighted:
                w_imu = np.concatenate(marginals.preint_edge_sqrt_info_diag(
                    e["cov_r_diag"], e["cov_p_diag"], e["dt"], vel_sigma=pcfg.imu_vel_sigma,
                    min_sigma_t=pcfg.min_sigma_t, min_sigma_r=pcfg.min_sigma_r))
            else:
                w_imu = fallback(pcfg.imu_weight_t, pcfg.imu_weight_r)
            self.pg_edges.append(PgEdge(
                fid0, int(kf_id[1]), np.asarray(e["dr"], np.float32),
                np.asarray(e["t_rel"], np.float32), w_imu, "imu",
                v0=np.asarray(cap["cap_vel0"], np.float32), r0=np.asarray(kf_r[0], np.float32),
                dt=e["dt"], dp=np.asarray(e["dp"], np.float32)))

    def optimize_pose_graph(self):
        """Pose-graph solve over the evicted history and the live window.
        Without loop edges: SE(3), the live window pinned at its refined
        poses. With loop edges and no IMU: Sim(3) with the drift-floor
        weights on odometry edges, only the first node pinned. With loop
        edges and the IMU: SE(3) with capped loop weights, first node
        pinned. Refined poses (and Sim(3) scales) go to the export log.
        Returns the solver's result, or None without history."""
        pcfg = self.cfg.pose_graph
        if not pcfg.enabled or not self.pg_nodes or self.n_kf_host == 0:
            return None
        win_fids = [int(f) for f in self.win.kf_id[:self.n_kf_host].cpu().numpy() if f >= 0]
        known = set(self.pg_nodes)
        nodes = list(self.pg_nodes) + [f for f in win_fids if f not in known]
        idx = {f: i for i, f in enumerate(nodes)}
        edges = [e for e in self.pg_edges if e.fi in idx and e.fj in idx]
        if not edges:
            return None
        p, c = len(nodes), len(edges)
        rs = np.zeros((p, 3, 3), np.float32)
        ts_ = np.zeros((p, 3), np.float32)
        for f, i in idx.items():
            logged = self.kf_pose_log.get(f)
            if logged is None:
                return None
            rs[i], ts_[i] = logged
        fixed = np.zeros(p, bool)
        # Gauge: with odometry edges only, the live window is the best
        # estimate and the history follows it; with loop edges the drift
        # sits in the recent keyframes, so only the world anchor is fixed.
        have_loops = any(e.kind == "loop" for e in edges)
        if not have_loops:
            for f in win_fids:
                fixed[idx[f]] = True
        fixed[idx[nodes[0]]] = True
        ei = np.asarray([idx[e.fi] for e in edges], np.int64)
        ej = np.asarray([idx[e.fj] for e in edges], np.int64)
        rel_r = np.stack([e.rel_r for e in edges]).astype(np.float32)
        rel_t = np.stack([e.rel_t for e in edges]).astype(np.float32)
        w = np.stack([e.w_sqrt for e in edges]).astype(np.float32)
        use_sim3 = have_loops and not self.imu_initialized
        if use_sim3:
            # monocular VO + loops: scale drift dominates and only Sim(3)
            # expresses it; odometry weights get the systematic-drift floor
            w = np.concatenate([w, np.zeros((c, 1), np.float32)], 1)
            for k, e in enumerate(edges):
                w[k, 6] = 1.0 / (pcfg.sim3_loop_scale_sigma if e.kind == "loop"
                                 else pcfg.sim3_odom_scale_sigma)
                if e.kind != "loop":
                    sig_t = 0.05 * float(np.linalg.norm(e.rel_t)) + 1e-3
                    w[k, :3] = np.minimum(w[k, :3], 1.0 / sig_t)
                    w[k, 3:6] = np.minimum(w[k, 3:6], 1.0 / 0.03)
        elif have_loops:
            # SE(3) / VIO graph: cap the loop weights at their single-edge accuracy
            for k, e in enumerate(edges):
                if e.kind == "loop":
                    w[k, :3] = np.minimum(w[k, :3], 100.0)
                    w[k, 3:6] = np.minimum(w[k, 3:6], 150.0)
        dev = self.device
        args = [torch.as_tensor(a, device=dev) for a in (rs, ts_, ei, ej, rel_r, rel_t, w)]
        args += [torch.ones(c, dtype=torch.bool, device=dev), torch.as_tensor(fixed, device=dev)]
        with self._stage("pose_graph"):
            if use_sim3:
                res = pg_mod.optimize_pose_graph_sim3(*args, max_iterations=pcfg.max_iterations)
                ls_out = res.log_s.cpu().numpy()
            else:
                res = pg_mod.optimize_pose_graph(*args, max_iterations=pcfg.max_iterations)
            r_out, t_out = res.r_wb.cpu().numpy(), res.t_wb.cpu().numpy()
        for f, i in idx.items():
            if not fixed[i]:
                self.kf_pose_log[f] = (r_out[i], t_out[i])
                if use_sim3:
                    # non-keyframes re-derive through anchors taken at the local scale
                    self.kf_scale_log[f] = float(np.exp(ls_out[i]))
        return res

    def _transform_history(self, r_wg, scale, t_anchor=None):
        """Re-express the recorded trajectory, the export log, the pose-graph
        edges, the place database and the live pose in the gravity-aligned,
        rescaled world (anchored at the first keyframe, as
        align_gravity_and_scale)."""
        r_gw = np.asarray(r_wg.cpu().numpy() if torch.is_tensor(r_wg) else r_wg).T
        s = float(scale)
        if t_anchor is None:
            t_anchor = r_gw @ self.win.kf_t[0].cpu().numpy()
        t_anchor = np.asarray(t_anchor)
        xf = lambda p: t_anchor + (r_gw @ p - t_anchor) * s
        self.trajectory = [(t, r_gw @ r, xf(p)) for (t, r, p) in self.trajectory]
        self.kf_pose_log = {fid: (r_gw @ r, xf(p)) for fid, (r, p) in self.kf_pose_log.items()}
        self.traj_rel = [None if e is None else (e[0], e[1], e[2] * s) for e in self.traj_rel]
        # Edge rotations are invariant; visual translations scale by s. IMU
        # edges do not: their dP and gravity terms are metric, so they are
        # re-derived from v0' = s R_gw v0, R0' = R_gw R0 (gravity stays canonical).
        g = self.gravity_w.cpu().numpy()

        def xf_edge(e: PgEdge) -> PgEdge:
            if e.kind != "imu":
                return dataclasses.replace(e, rel_t=e.rel_t * s)
            v0, r0 = s * (r_gw @ e.v0), r_gw @ e.r0
            t_rel = r0.T @ (v0 * e.dt + 0.5 * g * e.dt * e.dt) + e.dp
            return dataclasses.replace(e, rel_t=np.asarray(t_rel, np.float32),
                                       v0=np.asarray(v0, np.float32), r0=np.asarray(r0, np.float32))

        self.pg_edges = [xf_edge(e) for e in self.pg_edges]
        if self.last_kf_capture is not None:
            kr, kp = self.last_kf_capture
            self.last_kf_capture = (r_gw @ kr, xf(kp))
        if self.loop_closer is not None:
            self.loop_closer.transform(r_gw, s, t_anchor)
        r_gw_t = torch.as_tensor(r_gw, dtype=torch.float32, device=self.device)
        t_a = torch.as_tensor(t_anchor, dtype=torch.float32, device=self.device)
        self.r_cur, self.r_prev = r_gw_t @ self.r_cur, r_gw_t @ self.r_prev
        self.t_cur = t_a + (r_gw_t @ self.t_cur - t_a) * s
        self.t_prev = t_a + (r_gw_t @ self.t_prev - t_a) * s
        self.vel_cur = (r_gw_t @ self.vel_cur) * s

    def _tracking_step(self, image, timestamp) -> FrameResult:
        cfg = self.cfg
        rows = self.last_imu_rows
        buf = self._upload(image, timestamp, rows)
        with self._stage("tracking_step"):
            self.track, r_new, t_new, v_new, bundle = fused.tracking_step(
                self.track, self.win, self.img_prev, buf, self.gen, self.r_cur, self.t_cur,
                self.r_prev, self.t_prev, self.vel_cur, self.r_bc, self.r_cb, self.t_cb, cfg,
                bg=self.bg, ba=self.ba, gravity_w=self.gravity_w, use_imu=self.imu_initialized,
                n_imu=min(len(rows), cfg.imu.max_samples_per_frame), stage=self._stage,
            )
            b = fused.unpack_bundle(bundle.cpu().numpy())
        self.img_prev = buf
        self.r_prev, self.t_prev = self.r_cur, self.t_cur
        self.r_cur, self.t_cur, self.vel_cur = r_new, t_new, v_new
        diag = {"pnp_cost": b["pnp_cost"], "parallax": b["parallax"],
                "n_shared": b["n_shared"], "n_active": b["n_active"]}
        r_np, t_np = b["r"], b["t"]
        state = "tracking" if b["success"] else "tracking_lost"
        if b["is_kf"]:
            r_np, t_np = self._create_keyframe(timestamp, diag)
            if self.loop_closer is not None:
                r_np, t_np = self._loop_on_keyframe(diag, r_np, t_np)
            self.lost_streak = 0
        elif b["success"]:
            self.lost_streak = 0
        else:
            self.lost_streak += 1
            if (self.loop_closer is not None and self.lost_streak >= cfg.loop.reloc_after
                    and self.loop_closer.n_entries > 0):
                got = self._try_relocalize(diag)
                if got is not None:
                    r_np, t_np = got
                    state = "relocalized"
                    self.lost_streak = 0
        self._record(timestamp, r_np, t_np)
        return FrameResult(self.frame_id, timestamp, state, np.asarray(r_np), np.asarray(t_np),
                           b["is_kf"], b["n_tracked"], b["n_inliers"], diag)

    def _kf_rows(self) -> np.ndarray:
        return (np.concatenate(self.imu_since_last_kf) if self.imu_since_last_kf
                else np.zeros((0, 7)))

    def _create_keyframe(self, timestamp, diag):
        if self.imu_initialized == self.has_imu_stream:
            return self._create_keyframe_fused(timestamp, diag)
        return self._create_keyframe_pending_imu(timestamp, diag)

    def _create_keyframe_fused(self, timestamp, diag):
        """The keyframe event (fused.keyframe_step) + host bookkeeping."""
        cfg = self.cfg
        use_imu = self.imu_initialized
        max_kf = cfg.window.max_keyframes
        was_full = self.n_kf_host == max_kf
        n_kf_after = min(self.n_kf_host + 1, max_kf)
        pairs_after = min(self.n_pairs + 1, max_kf - 1) if use_imu else self.n_pairs
        do_refine = (use_imu and self.scale_refine_count < cfg.window.max_scale_refines
                     and n_kf_after >= 3 and pairs_after == n_kf_after - 1)
        rows = None
        if use_imu:
            cap = cfg.imu.max_samples_per_keyframe
            kf_rows = self._kf_rows()
            rows = torch.as_tensor(np.asarray(kf_rows[len(kf_rows) - min(len(kf_rows), cap):],
                                              np.float32).reshape(-1, 7), device=self.device)
        capture = was_full and cfg.pose_graph.enabled
        with self._stage("keyframe_step"):
            (self.track, self.win, self.preints, self.bg, self.ba, self.r_cur, self.t_cur,
             self.vel_cur, record) = fused.keyframe_step(
                cfg, self.track, self.win, float(timestamp), self.frame_id, self.r_cur, self.t_cur,
                self.vel_cur, self.t_bc, use_imu=use_imu, preints=self.preints,
                n_pairs=self.n_pairs, was_full=was_full, do_refine=do_refine, imu_rows=rows,
                bg=self.bg, ba=self.ba, gravity_w=self.gravity_w, capture=capture,
                stage=self._stage,
            )
            rec = fused.unpack_kf_record(record.cpu().numpy(), max_kf)
        self.n_kf_host = n_kf_after
        self.n_pairs = pairs_after
        self.imu_since_last_kf = []
        # eviction edges, in the pre-refine world like the rest of the history
        if capture:
            self._append_pg_edges_host(rec, use_imu)
        if rec["refine_applied"]:
            # the window and the live pose came out aligned; the history did not
            self.scale_refine_count += 1
            diag["scale_refine"] = rec["refine_s"]
            cur = (self.r_cur, self.t_cur, self.vel_cur)
            self._transform_history(rec["r_wg"], rec["refine_s"], t_anchor=rec["t_anchor"])
            self.r_cur, self.t_cur, self.vel_cur = cur
        return self._finish_keyframe(diag, rec)

    def _create_keyframe_pending_imu(self, timestamp, diag):
        """Keyframe while an IMU stream exists but IMU init is pending (it
        was rejected at bootstrap): window BA, the new pair's
        preintegration kept, and a retry of IMU init on the refined window."""
        cfg = self.cfg
        if self.n_kf_host == cfg.window.max_keyframes and cfg.pose_graph.enabled:
            self._record_pose_graph_eviction()
        ids = torch.where(self.track.valid, self.track.ids, torch.full_like(self.track.ids, -1))
        self.win = window.add_keyframe(self.win, self.r_cur, self.t_cur, self.vel_cur, self.bg,
                                       self.ba, float(timestamp), self.frame_id, self.track.uv, ids)
        self.n_kf_host = min(self.n_kf_host + 1, cfg.window.max_keyframes)
        newp = self._preintegrate(self._kf_rows(), self.bg, self.ba,
                                  cfg.imu.max_samples_per_keyframe)
        n_max = cfg.window.max_keyframes - 1
        evict = self.n_pairs == n_max
        self.preints = pre.append(self.preints, newp, n_max - 1 if evict else self.n_pairs, evict)
        self.n_pairs = min(self.n_pairs + 1, n_max)
        self.imu_since_last_kf = []
        res = self._window_ba()
        if self.n_pairs == self.n_kf_host - 1 and self._try_initialize_imu():
            diag["imu_initialized"] = True
        w, h = cfg.camera.width, cfg.camera.height
        self.track = fused._relabel_tracks(
            self.track, fused._bad_slots(self.track, self.win.lm_slot, self.win.lm_feat_id,
                                         res.new_bad))
        with self._stage("triangulation"):
            self.win, n_new, n_dropped = window.triangulate_new_landmarks(
                self.win, self.t_bc, w, h, live_ids=self.track.ids)
        i_last = self.n_kf_host - 1
        self.r_cur, self.t_cur = self.win.kf_r[i_last], self.win.kf_t[i_last]
        record = fused.kf_record(res, self.win, n_new, n_dropped)
        return self._finish_keyframe(diag, fused.unpack_kf_record(record.cpu().numpy(),
                                                                  cfg.window.max_keyframes))

    def _finish_keyframe(self, diag, rec):
        """Export log, keyframe anchor and diagnostics from a keyframe record."""
        i_last = self.n_kf_host - 1
        for i in range(self.n_kf_host):
            fid = int(rec["kf_id"][i])
            if fid >= 0:
                self.kf_pose_log[fid] = (rec["kf_r"][i], rec["kf_t"][i])
        self.last_kf_fid = self.frame_id
        self.last_kf_capture = (rec["kf_r"][i_last], rec["kf_t"][i_last])
        self._last_kf_window_host = (rec["kf_id"], rec["kf_r"], rec["kf_t"])
        if rec["n_dropped"]:
            log.warning("landmark slots saturated: dropped %d new landmarks (capacity %d)",
                        rec["n_dropped"], self.win.max_lm)
        diag.update(n_new_landmarks=rec["n_new"], n_lm_dropped=rec["n_dropped"],
                    n_lm_alive=rec["n_lm_alive"], n_lm_marginalized=rec["n_lm_marg"],
                    ba_cost=rec["ba_cost"], ba_inliers=rec["ba_inliers"])
        return rec["kf_r"][i_last], rec["kf_t"][i_last]

    # ------------------------------------------------------------------
    # Loop closure and relocalization
    # ------------------------------------------------------------------

    def _loop_on_keyframe(self, diag, r_np, t_np):
        """Ingest the new keyframe into the place database and, when it is
        queryable, retrieve + verify a loop candidate. An accepted closure
        appends a ``loop`` edge and, above the correction floors, rigidly
        corrects the live window, map and pose (yaw only once the IMU is
        initialized: gravity alignment must survive). The image is the
        u8-quantized frame, as the reference's."""
        lc = self.loop_closer
        ids = torch.where(self.track.valid, self.track.ids, torch.full_like(self.track.ids, -1))
        with self._stage("loop"):
            hit = lc.on_keyframe(fused.buf_image(self.img_prev, self.cfg.camera.height),
                                 self.track.uv, ids, self.track.valid, self.win, self.r_cur,
                                 self.t_cur, self.r_cb, self.t_cb, self.frame_id,
                                 yaw_only=self.imu_initialized)
        if hit is None:
            return r_np, t_np
        lcfg = self.cfg.loop
        w = np.concatenate([np.full(3, lcfg.edge_weight_t),
                            np.full(3, lcfg.edge_weight_r)]).astype(np.float32)
        self.pg_edges.append(PgEdge(hit["old_fid"], hit["cur_fid"], hit["rel_r"].astype(np.float32),
                                    hit["rel_t"].astype(np.float32), w, "loop"))
        diag["loop_closed_to"] = hit["old_fid"]
        diag["loop_inliers"] = hit["n_inliers"]
        diag["loop_score"] = round(hit["score"], 3)
        if not hit["apply_correction"]:
            return r_np, t_np  # edge recorded; correction below the noise floor
        rc, tc = hit["corr_r"], hit["corr_t"]
        dev = self.device
        (self.win, self.r_cur, self.t_cur, self.r_prev, self.t_prev,
         self.vel_cur) = loop_mod.apply_world_correction(
            self.win, torch.as_tensor(rc, device=dev), torch.as_tensor(tc, device=dev), self.r_cur,
            self.t_cur, self.r_prev, self.t_prev, self.vel_cur)
        # host mirrors of everything the correction moved
        if self._last_kf_window_host is not None:
            kf_id_h, kf_r_h, kf_t_h = self._last_kf_window_host
            for i in range(len(kf_id_h)):
                if int(kf_id_h[i]) >= 0:
                    self.kf_pose_log[int(kf_id_h[i])] = (rc @ kf_r_h[i], rc @ kf_t_h[i] + tc)
        if self.last_kf_capture is not None:
            kr, kp = self.last_kf_capture
            self.last_kf_capture = (rc @ kr, rc @ kp + tc)
        log.info("loop closure: frame %d -> %d (%d matches, %d inliers, score %.2f, |dt|=%.3f m)",
                 self.frame_id, hit["old_fid"], hit["n_match"], hit["n_inliers"], hit["score"],
                 float(np.linalg.norm(tc)))
        return rc @ r_np, rc @ t_np + tc

    def _try_relocalize(self, diag):
        """Query the place database with the current (lost) frame and PnP
        against the best candidate's stored landmarks. On success: reset
        the pose, zero the velocity, and inject the matched landmarks as
        marginalized entries linked to the current tracker ids, so PnP has
        associations again on the next frame."""
        lc = self.loop_closer
        ids = torch.where(self.track.valid, self.track.ids, torch.full_like(self.track.ids, -1))
        with self._stage("reloc"):
            rec, r_b, t_b, inj_pos, inj_ok = lc.relocalize(
                fused.buf_image(self.img_prev, self.cfg.camera.height), self.track.uv, ids,
                self.track.valid, self.r_cb, self.t_cb)
        if rec is None:
            return None
        self.r_cur, self.t_cur = r_b, t_b
        self.r_prev, self.t_prev = r_b, t_b
        self.vel_cur = torch.zeros(3, device=self.device)
        i_last = max(self.n_kf_host - 1, 0)
        self.win = loop_mod.inject_landmarks(self.win, inj_pos, inj_ok, ids, self.win.kf_id[i_last])
        diag["reloc_to"] = rec["old_fid"]
        diag["reloc_inliers"] = rec["n_inliers"]
        log.info("relocalized against frame %d (%d inliers, score %.2f)", rec["old_fid"],
                 rec["n_inliers"], rec["score"])
        return r_b.cpu().numpy(), t_b.cpu().numpy()

    # ------------------------------------------------------------------
    # Async frame API and run lifecycle
    # ------------------------------------------------------------------

    def process_frame_async(self, image, timestamp: float, imu: np.ndarray | None = None) -> list:
        """``process_frame`` under the JAX package's pipelined contract:
        returns the FrameResults that became available, in frame order,
        each equal to what ``process_frame`` returns; ``flush()`` resolves
        whatever is still in flight. The port resolves every frame in its
        own call: its tracking frame is host-bound on the card and already
        ends in one fetch of its result bundle, so deferring that fetch
        behind the next frame's work would hide little; nothing is ever in
        flight and this returns the frame's own result."""
        return [self.process_frame(image, timestamp, imu)]

    def flush(self) -> list:
        """Resolve every in-flight frame (none: see ``process_frame_async``)."""
        return []

    def reset(self) -> None:
        """Back to the pre-bootstrap state on the same device with the
        same configuration; tracking, map, inertial and trajectory state
        are discarded and the generator is seeded afresh."""
        self.__init__(self.cfg, self.device, self.seed)

    def capture_state(self) -> dict:
        """The complete mutable state (``_STATE``), sharing no storage with
        the live estimator."""
        self.flush()  # resolve any in-flight frame first
        state = {"version": 1, "package": "vio360_tpu_torch"}
        for name in self._STATE:
            v = getattr(self, name)
            if name == "gen":
                v = v.get_state()
            elif name == "loop_closer":
                v = None if v is None else v.capture_state()
            state[name] = ckpt.copy_tree(v)
        return state

    def restore_state(self, state: dict, copy: bool = True) -> None:
        """Set the state captured by ``capture_state`` (or read by ``load``).
        ``copy=False`` takes over the leaves instead of copying them, for a
        state that nothing else holds (``load``'s, just read from a file)."""
        if state.get("package") != "vio360_tpu_torch":
            raise ValueError("not a state of the port: convert a JAX package state with "
                             "convert.state_from_jax (Estimator.load does)")
        for name in self._STATE:
            v = state[name]
            if name == "gen":
                gen_state = v.cpu()
                if gen_state.numel() != self.gen.get_state().numel():
                    # a state saved on another device type: seed from its bytes
                    self.gen.manual_seed(generator_seed(gen_state.numpy()))
                else:
                    self.gen.set_state(gen_state)
            elif name == "loop_closer":
                if (v is None) != (self.loop_closer is None):
                    raise ValueError("checkpoint and configuration disagree on loop closure")
                if v is not None:
                    self.loop_closer.restore_state(v, copy)
            else:
                setattr(self, name, ckpt.copy_tree(v, self.device, copy))

    def save(self, path: str) -> None:
        ckpt.save_state(path, self.capture_state())

    @classmethod
    def load(cls, path: str, cfg: VioConfig, device: str | torch.device | None = None
             ) -> "Estimator":
        """An estimator resumed from a checkpoint of the port or of the JAX
        package (converted by ``convert.state_from_jax``)."""
        est = cls(cfg, device=device)
        state = ckpt.load_state(path, est.device)
        if state.get("package") != "vio360_tpu_torch":
            from .. import convert

            state = convert.state_from_jax(state, est.device)
        est.restore_state(state, copy=False)
        return est

    def export_trajectory(self):
        """Trajectory with keyframes at their latest refined poses and
        non-keyframes re-derived from their reference keyframe (scaled by
        its Sim(3) scale); a pose-graph solve first propagates the live
        window's refinements back through the evicted history."""
        self.optimize_pose_graph()
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
                ps[i] = kp + kr @ (rel_p * self.kf_scale_log.get(kf_fid, 1.0))
        for fid, (r, p) in self.kf_pose_log.items():
            if 0 <= fid < len(ts):
                rs[fid] = r
                ps[fid] = p
        return ts, rs, ps
