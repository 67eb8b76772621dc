"""Estimator state snapshots on disk: save and load mid-sequence.

The JAX package's format (``vio360_tpu/io/checkpoint.py``): one ``.npz``
holding every array leaf under a path-derived name, and a JSON manifest
of the structure and the scalar fields under ``__manifest__``; no pickle,
so a checkpoint is safe to load from untrusted storage. Tensor leaves are
written as numpy from ``.cpu()`` and marked in the manifest, so that
``load_state`` returns them as tensors on the caller's device and numpy
leaves as numpy; numpy scalars keep their dtype.

Dataclass nodes resolve only from an allowlist of the port's state
classes. A tag of the JAX package (``vio360_tpu.frontend.tracker:
TrackState``) maps by name to the port's class of the same name and is
never imported, so a file the JAX package wrote loads here without JAX
(``convert.state_from_jax`` turns its state into the port's).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os

import numpy as np
import torch

#: the dataclasses a state may hold: tag without the package prefix -> port module
_STATE_CLASSES = {
    "frontend.tracker:TrackState": "frontend.tracker",
    "estimator.window:WindowState": "estimator.window",
    "imu.preintegration:Preintegration": "imu.preintegration",
    "loop.closure:LoopDb": "loop.closure",
    "estimator.estimator:PgEdge": "estimator.estimator",
}
_PACKAGES = ("vio360_tpu_torch.", "vio360_tpu.")


def _tag(obj) -> str:
    return type(obj).__module__ + ":" + type(obj).__qualname__


def _resolve(tag: str) -> type:
    """The port's class for a port or JAX package tag on the allowlist."""
    for pkg in _PACKAGES:
        if tag.startswith(pkg) and tag[len(pkg):] in _STATE_CLASSES:
            rel = tag[len(pkg):]
            module = importlib.import_module("vio360_tpu_torch." + _STATE_CLASSES[rel])
            return getattr(module, rel.split(":")[1])
    raise ValueError(f"checkpoint names a class outside the state allowlist: {tag}")


def _flatten(prefix: str, obj, out: dict):
    """Nested dict / list / tuple / dataclass -> JSON-able descriptor; array
    leaves go to ``out`` under their path."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, dict):
        keys = sorted(obj.keys())
        return {"t": "dict", "k": keys, "v": [_flatten(f"{prefix}.{k}", obj[k], out) for k in keys]}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "v": [_flatten(f"{prefix}.{i}", x, out) for i, x in enumerate(obj)]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        tag = _tag(obj)
        _resolve(tag)  # refuse to write what could not be read back
        fields = [f.name for f in dataclasses.fields(obj)]
        return {"t": "dc", "cls": tag, "k": fields,
                "v": [_flatten(f"{prefix}.{f}", getattr(obj, f), out) for f in fields]}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}
    if torch.is_tensor(obj):
        out[prefix] = obj.detach().cpu().numpy()
        return {"t": "arr", "name": prefix, "torch": True}
    if isinstance(obj, np.generic):
        out[prefix] = np.asarray(obj)
        return {"t": "arr", "name": prefix, "scalar": True}
    out[prefix] = np.asarray(obj)
    return {"t": "arr", "name": prefix}


def _unflatten(desc, arrays: dict, device):
    t = desc["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _unflatten(v, arrays, device) for k, v in zip(desc["k"], desc["v"])}
    if t in ("list", "tuple"):
        vals = [_unflatten(v, arrays, device) for v in desc["v"]]
        return vals if t == "list" else tuple(vals)
    if t == "dc":
        cls = _resolve(desc["cls"])
        return cls(**{k: _unflatten(v, arrays, device) for k, v in zip(desc["k"], desc["v"])})
    if t == "py":
        return desc["v"]
    a = arrays[desc["name"]]
    if desc.get("torch"):
        return torch.from_numpy(np.array(a)).to(device)
    return a[()] if desc.get("scalar") else a


def save_state(path: str, state: dict) -> None:
    """Write a state dict (nested containers and state dataclasses with
    tensor, numpy or Python leaves) to ``path`` atomically."""
    arrays: dict[str, np.ndarray] = {}
    manifest = _flatten("s", state, arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __manifest__=np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8),
                 **arrays)
    os.replace(tmp, path)


def load_state(path: str, device=None) -> dict:
    """Read a state dict written by either package; the port's tensor
    leaves land on ``device`` (default: the CPU), all others are numpy."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    return _unflatten(manifest, arrays, torch.device("cpu") if device is None else device)


def copy_tree(obj, device=None, copy: bool = True):
    """A copy of a state tree that shares no storage with it: tensors
    cloned (and moved to ``device`` when given), numpy arrays copied,
    containers and dataclasses rebuilt. With ``copy=False`` the leaves are
    only moved to ``device`` (no copy where they already lie there), for a
    tree that nothing else holds, such as one just read from a file."""
    if torch.is_tensor(obj):
        obj = obj.to(device) if device is not None else obj
        return obj.clone() if copy else obj
    if isinstance(obj, np.ndarray):
        return obj.copy() if copy else obj
    if isinstance(obj, dict):
        return {k: copy_tree(v, device, copy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        vals = [copy_tree(v, device, copy) for v in obj]
        return vals if isinstance(obj, list) else tuple(vals)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: copy_tree(getattr(obj, f.name), device, copy)
                                           for f in dataclasses.fields(obj)})
    return obj
