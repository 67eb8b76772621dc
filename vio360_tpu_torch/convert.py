"""Carry tracker, window and inertial state between the JAX package and the port.

The JAX package's ``TrackState`` / ``WindowState`` / ``Preintegration``
travel as dicts of numpy arrays (``to_numpy``, which reads any
dataclass of arrays without importing JAX), so tests can start both
implementations from one state; ``vio_state`` reads an estimator's
inertial fields the same way. A place database (``LoopDb``) travels the
same way, and pose-graph edges (``PgEdge`` of either package) as dicts of
their fields (``edge_fields``), from which each package builds its own.
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
