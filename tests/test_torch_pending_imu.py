"""The port's keyframe path while IMU init is pending, against the JAX package.

IMU init rejected at bootstrap, so keyframes take the staged path
(``Estimator._create_keyframe_pending_imu``: window BA, the pair's
preintegration, an IMU-init retry). With a full 4-keyframe window each
such keyframe first captures eviction edges; their covariance weights
must equal JAX's ``window_pair_sqrt_info`` on the converted pre-eviction
window (2e-3 relative, tests/test_marginals.py's bound).
"""

import dataclasses
import os

import numpy as np
import torch

try:
    import jax  # noqa: F401

    from test_torch_pose_graph import _check_pair_w
    from test_torch_port import port_cfg
    from vio360_tpu import config as cfgmod
except ModuleNotFoundError as e:
    # A card's machine may have no JAX: there only ``pytest -m cuda`` is meaningful.
    if e.name != "jax":
        raise
from vio360_tpu_torch import synthetic as tsyn
from vio360_tpu_torch.estimator import estimator as port_est, fused as tfused
from vio360_tpu_torch.io import dataset as tds

torch.set_num_threads(1)

W, H = 480, 240
CFG = os.path.join(os.path.dirname(__file__), "..", "configs", "synthetic_480.yaml")


FRAMES = 16


def test_pending_imu_keyframes_capture_eviction_edges(tmp_path, monkeypatch):
    """IMU init rejected at bootstrap, so keyframes take the pending path
    (window BA, the pair's preintegration, an IMU-init retry); with a full
    4-keyframe window each one first captures eviction edges with the
    covariance weights of the pre-eviction window."""
    jcfg = dataclasses.replace(cfgmod.load_yaml(CFG),
                               window=cfgmod.WindowConfig(max_keyframes=4),
                               loop=cfgmod.LoopConfig(enabled=False))
    cfg = port_cfg(jcfg)
    tsyn.make_dataset(str(tmp_path), frames=FRAMES, width=W, height=H, seed=11)
    data = tds.VioDataset(str(tmp_path), image_size=(W, H))
    est = port_est.Estimator(cfg, device="cpu")
    attempts, real_init = [], est._try_initialize_imu
    monkeypatch.setattr(est, "_try_initialize_imu",
                        lambda: attempts.append(est.frame_id) or (len(attempts) > 1 and real_init()))
    captured = []
    real_capture = tfused.eviction_capture

    def capture(cfg_, win, *a, **kw):
        out = real_capture(cfg_, win, *a, **kw)
        captured.append((win, out[42:54].reshape(2, 6).numpy()))
        return out

    monkeypatch.setattr(tfused, "eviction_capture", capture)
    pending = 0
    for frame in data:
        pending += est.initialized and est.has_imu_stream and not est.imu_initialized
        est.process_frame(frame.image, frame.timestamp, frame.imu)
    assert len(attempts) >= 2, "IMU init was not retried on the pending path"
    assert pending and captured, "no pending keyframe evicted"
    _check_pair_w(captured, jcfg, est)
    assert len(est.pg_nodes) == len(captured)
    w01 = np.stack([e.w_sqrt for e in est.pg_edges if e.kind == "vis"][:len(captured)])
    np.testing.assert_allclose(w01, np.stack([p[0] for _, p in captured]), rtol=1e-6)
