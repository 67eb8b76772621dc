"""Trajectory export/import in the TUM and KITTI formats.

The port's own copy of ``vio360_tpu/io/trajectory.py``.
"""

from __future__ import annotations

import numpy as np


def _rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    """[3,3] -> quaternion (x, y, z, w), Shepperd's method."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w, x = 0.25 * s, (r[2, 1] - r[1, 2]) / s
        y, z = (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        w, x = (r[2, 1] - r[1, 2]) / s, 0.25 * s
        y, z = (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        w, x = (r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s
        y, z = 0.25 * s, (r[1, 2] + r[2, 1]) / s
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        w, x = (r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s
        y, z = (r[1, 2] + r[2, 1]) / s, 0.25 * s
    return np.array([x, y, z, w])


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(x, y, z, w) -> [3,3]."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def write_tum(path: str, timestamps, rotations, translations) -> None:
    """TUM format: ``t tx ty tz qx qy qz qw`` per line (T_wb poses)."""
    with open(path, "w") as f:
        for t, r, p in zip(timestamps, rotations, translations):
            q = _rotmat_to_quat(np.asarray(r))
            f.write(f"{t:.9f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")


def read_tum(path: str):
    """-> (timestamps [N], rotations [N,3,3], translations [N,3])."""
    ts, rs, ps = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 8 or parts[0].startswith("#"):
                continue
            vals = [float(x) for x in parts]
            ts.append(vals[0])
            ps.append(vals[1:4])
            rs.append(quat_to_rotmat(np.asarray(vals[4:8])))
    return np.asarray(ts), np.asarray(rs), np.asarray(ps)


def write_kitti(path: str, rotations, translations) -> None:
    """KITTI format: the 12 values of the 3x4 [R|t] per line."""
    with open(path, "w") as f:
        for r, p in zip(rotations, translations):
            m = np.concatenate([np.asarray(r), np.asarray(p).reshape(3, 1)], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in m.reshape(-1)) + "\n")
