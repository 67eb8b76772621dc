"""Carry tracker, window and inertial state between the JAX package and the port.

The JAX package's ``TrackState`` / ``WindowState`` / ``Preintegration``
travel as dicts of numpy arrays (``to_numpy``, which reads any
dataclass of arrays without importing JAX), so tests can start both
implementations from one state; ``vio_state`` reads an estimator's
inertial fields the same way. A place database (``LoopDb``) travels the
same way, and pose-graph edges (``PgEdge`` of either package) as dicts of
their fields (``edge_fields``), from which each package builds its own.
``state_from_jax`` turns a JAX package checkpoint's state into the
port's, so ``Estimator.load`` resumes a JAX run on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .estimator.window import WindowState
from .frontend.tracker import TrackState
from .imu.preintegration import Preintegration
from .loop.closure import LoopDb


def to_numpy(state) -> dict[str, np.ndarray]:
    """Fields of a state dataclass (JAX or port) as numpy arrays."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out[f.name] = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def _from_numpy(cls, arrays: dict, device):
    kw = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(arrays[f.name])
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        kw[f.name] = torch.as_tensor(np.array(a, order="C"), device=device)  # keeps 0-d scalars 0-d
    return cls(**kw)


def track_from_numpy(arrays: dict, device=None) -> TrackState:
    return _from_numpy(TrackState, arrays, device)


def window_from_numpy(arrays: dict, device=None) -> WindowState:
    return _from_numpy(WindowState, arrays, device)


def preint_from_numpy(arrays: dict, device=None) -> Preintegration:
    """A (possibly stacked) preintegration from ``to_numpy`` arrays."""
    return _from_numpy(Preintegration, arrays, device)


def loop_db_from_numpy(arrays: dict, device=None) -> LoopDb:
    return _from_numpy(LoopDb, arrays, device)


def edge_fields(edge) -> dict:
    """A pose-graph edge of either package as a dict of its fields (numpy
    arrays copied); ``PgEdge(**edge_fields(e))`` builds it in the other."""
    return {f.name: (np.array(v) if isinstance(v, np.ndarray) else v)
            for f in dataclasses.fields(edge) for v in (getattr(edge, f.name),)}


#: the estimator's inertial state: tensors, then host scalars
VIO_TENSORS = ("bg", "ba", "vel_cur", "gravity_w")
VIO_SCALARS = ("n_pairs", "imu_initialized", "has_imu_stream", "scale_refine_count")


def vio_state(est) -> dict:
    """The inertial state of an estimator (JAX or port) as numpy arrays
    and host scalars: stacked pair preintegrations, biases, velocity,
    gravity, live pair count and the IMU flags."""
    out = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v, np.float32)
           for k, v in ((k, getattr(est, k)) for k in VIO_TENSORS)}
    out.update({k: getattr(est, k) for k in VIO_SCALARS})
    out["preints"] = to_numpy(est.preints)
    return out


_SNAPSHOT_TENSORS = ("uv", "ids", "valid", "track_count")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a, order="C"), device=device)


def _dc(obj, cls, device):
    """A state dataclass of either package (numpy or tensor leaves) as the port's ``cls``."""
    return _from_numpy(cls, to_numpy(obj), device)


def state_from_jax(state: dict, device) -> dict:
    """The port's ``Estimator.restore_state`` input from a state of the JAX
    package (``vio360_tpu.io.checkpoint.load_state``'s dict, or the port's
    ``io.checkpoint.load_state`` of a JAX file, in the JAX package's
    current format). Arrays become float32 / integer tensors on
    ``device``; the packed frame buffer has the same layout in both
    packages (``fused.pack_frame_input``; uint16 travels as int16 bits). The PRNG key
    seeds the generator (``estimator.generator_seed`` of its two uint32
    words), so RANSAC draws differently from JAX after the resume, as it
    does in any port run. Bootstrap snapshots drop ``age``, which the port
    does not keep. The JAX estimator's device-resident megastep carriers
    (``kf_rows_dev``, ``kf_count_dev``, ``n_pairs_dev``, ``refine_count_dev``,
    ``loop_seq_dev``, ``loop_db_dev``, ``rec_ring_dev``, ``_mega_active``)
    are not read: the port has no megastep, its host keeps the keyframe IMU
    rows, counters and pair count (read under their own names), the loop
    closer's database is the one under ``"loop"``, and no fetch is
    deferred, so no record ring exists."""
    from .estimator import fused
    from .estimator.estimator import PgEdge, generator_seed

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(generator_seed(np.asarray(state["key"], np.uint32)))
    out = {"version": 1, "package": "vio360_tpu_torch", "gen": gen.get_state()}
    for name in ("frame_id", "n_pairs", "scale_refine_count"):
        out[name] = int(state[name])
    for name in ("initialized", "imu_initialized", "has_imu_stream"):
        out[name] = bool(state[name])
    out["track"] = _dc(state["track"], TrackState, dev)
    out["win"] = _dc(state["win"], WindowState, dev)
    out["preints"] = _dc(state["preints"], Preintegration, dev)
    for name in ("r_cur", "t_cur", "r_prev", "t_prev", "vel_cur", "bg", "ba", "gravity_w"):
        out[name] = _tensor(state[name], dev)
    img = state["img_prev"]
    out["img_prev"] = None if img is None else fused.to_device(np.asarray(img), dev)
    out["snapshots"] = [
        {**{k: _tensor(sn[k], dev) for k in _SNAPSHOT_TENSORS}, "time": float(sn["time"]),
         "frame_id": int(sn["frame_id"]), "imu": np.asarray(sn["imu"], np.float64).reshape(-1, 7)}
        for sn in state["snapshots"]]
    out["imu_since_last_kf"] = [np.asarray(x) for x in state["imu_since_last_kf"]]
    out["last_imu_rows"] = np.zeros((0, 7))  # set again by the next frame before any use
    out["trajectory"] = [(float(e["t"]), np.asarray(e["r"]), np.asarray(e["p"]))
                         for e in state["trajectory"]]
    out["traj_rel"] = [None if not e else (int(e["kf"]), np.asarray(e["r"]), np.asarray(e["p"]))
                       for e in state["traj_rel"]]
    out["kf_pose_log"] = {int(f): (np.asarray(r), np.asarray(p))
                          for f, (r, p) in state["kf_pose_log"].items()}
    out["last_kf_fid"] = int(state["last_kf_fid"])
    cap = state["last_kf_capture"]
    out["last_kf_capture"] = None if cap is None else (np.asarray(cap[0]), np.asarray(cap[1]))
    out["n_kf_host"] = int(np.asarray(state["win"].n_kf))
    out["lost_streak"] = int(state["lost_streak"])
    out["_last_kf_window_host"] = None  # set by each keyframe event before the loop step reads it
    out["pg_nodes"] = [int(f) for f in state["pg_nodes"]]

    def edge(e: dict) -> PgEdge:
        f32 = lambda a: np.asarray(a, np.float32)
        kind = str(e["kind"])
        extra = ({"v0": f32(e["v0"]), "r0": f32(e["r0"]), "dt": float(e["dt"]), "dp": f32(e["dp"])}
                 if kind == "imu" else {})
        return PgEdge(int(e["i"]), int(e["j"]), f32(e["r"]), f32(e["t"]), f32(e["w"]), kind, **extra)

    out["pg_edges"] = [edge(e) for e in state["pg_edges"]]
    loop = state.get("loop")
    out["loop_closer"] = None if loop is None else {
        "db": _dc(loop["db"], LoopDb, dev), "entry_fid": np.asarray(loop["entry_fid"], np.int64),
        "entry_seq": np.asarray(loop["entry_seq"], np.int64), "seq": int(loop["seq"]),
        "last_correction_seq": int(loop["last_correction_seq"])}
    return out
