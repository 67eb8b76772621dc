"""Synthetic ERP scenes and VO sequences without JAX.

Counterpart of the renderers in ``tests/synthetic.py`` (``make_panorama``,
``render_textured_view``, ``render_point_image``, ``make_point_world``,
``make_trajectory``) and of the frame loop of
``tools/make_synthetic_dataset.py`` (``make_dataset``), in numpy and
torch, so a machine without JAX can render the same sequences. The
analytic trajectory is imported from the tool itself (numpy only at
module level). ``make_dataset`` writes the tool's noise-free sequence,
images and IMU stream, with the tool's closed-circuit revisit trajectory,
its photometric noise and its blackout; its other photometric and dynamic
nuisance options belong to later slices.
"""

from __future__ import annotations

import importlib.util
import os
from pathlib import Path

import numpy as np
import torch

from .geometry import camera as cam
from .geometry import lie
from .ops.pyramid import _blur_h, _blur_v
from .ops.sampling import bilinear_sample

_TOOL = Path(__file__).resolve().parents[1] / "tools" / "make_synthetic_dataset.py"


def _tool_trajectory(name: str):
    spec = importlib.util.spec_from_file_location("_make_synthetic_dataset", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


def make_panorama(seed: int, height: int, width: int, octaves: int = 4, device=None) -> torch.Tensor:
    """Smooth multi-octave random texture [H, W] in [0, 1]."""
    rng = np.random.default_rng(seed)
    img = np.zeros((height, width), np.float32)
    for o in range(octaves):
        h = max(4, height >> (octaves - 1 - o))
        w = max(8, width >> (octaves - 1 - o))
        t = torch.as_tensor(rng.standard_normal((h, w)).astype(np.float32), device=device)
        while t.shape[0] < height:
            t = t.repeat_interleave(2, 0).repeat_interleave(2, 1)
            t = _blur_v(_blur_h(t))
        img += t[:height, :width].cpu().numpy() * (0.5 ** (octaves - 1 - o))
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return torch.as_tensor(img, device=device)


def _pixel_grid(width: int, height: int, device) -> torch.Tensor:
    vv, uu = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                            torch.arange(width, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([uu, vv], -1)


def render_textured_view(pano: torch.Tensor, r_wc: torch.Tensor, t_wc: torch.Tensor, width: int,
                         height: int, radius: float = 6.0) -> torch.Tensor:
    """ERP view from inside a texture-mapped sphere of ``radius`` (true parallax)."""
    ph, pw = pano.shape
    b_c = cam.pixel_to_bearing(_pixel_grid(width, height, pano.device), width, height)
    b_w = b_c @ r_wc.T
    tb = b_w @ t_wc
    s = -tb + torch.sqrt(torch.clamp(tb * tb + radius * radius - (t_wc @ t_wc), min=1e-9))
    p_w = t_wc + s[..., None] * b_w
    dir_w = p_w / torch.linalg.norm(p_w, dim=-1, keepdim=True)
    return bilinear_sample(pano, cam.bearing_to_pixel(dir_w, pw, ph))


def make_point_world(seed: int, n_points: int = 400, radius=(4.0, 12.0)) -> np.ndarray:
    """Random 3D landmarks in a shell around the origin."""
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((n_points, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (dirs * rng.uniform(*radius, n_points)[:, None]).astype(np.float32)


def make_trajectory(n_frames: int, step: float = 0.08, rot_step: float = 0.01):
    """Smooth forward trajectory; returns (rs_wb [T,3,3], ts_wb [T,3])."""
    rs, ts = [], []
    r = np.eye(3, dtype=np.float32)
    t = np.zeros(3, dtype=np.float32)
    for i in range(n_frames):
        rs.append(r.copy())
        ts.append(t.copy())
        phi = np.array([0.2 * rot_step * np.sin(i * 0.3), rot_step, 0.1 * rot_step * np.cos(i * 0.2)],
                       np.float32)
        r = r @ lie.so3_exp(torch.as_tensor(phi)).numpy()
        t = t + r @ np.array([0.3 * step * np.sin(i * 0.1), 0.05 * step, step], np.float32)
    return np.stack(rs), np.stack(ts)


def render_point_image(points_w: np.ndarray, r_wc: np.ndarray, t_wc: np.ndarray, width: int,
                       height: int, sigma: float = 1.2, half: int = 4) -> np.ndarray:
    """Gaussian blob per visible landmark (real parallax under translation)."""
    p_c = (points_w - t_wc) @ r_wc
    uv = cam.project(torch.as_tensor(p_c, dtype=torch.float32), width, height).numpy()
    r = np.arange(-half, half + 1)
    dv, du = np.meshgrid(r, r, indexing="ij")
    offs = np.stack([du.reshape(-1), dv.reshape(-1)], -1)
    centers = np.floor(uv).astype(np.int64)
    frac = uv - centers
    pix = centers[:, None, :] + offs[None, :, :]
    d = offs[None] - frac[:, None, :]
    val = np.exp(-(d[..., 0] ** 2 + d[..., 1] ** 2) / (2 * sigma ** 2))
    px, py = np.mod(pix[..., 0], width), pix[..., 1]
    ok = (py >= 0) & (py < height)
    img = np.zeros((height, width), np.float32)
    np.add.at(img, (py[ok], px[ok]), val[ok])
    return np.clip(img, 0.0, 1.0)


def make_dataset(out_dir: str, frames: int = 40, width: int = 480, height: int = 240,
                 points: int = 500, seed: int = 11, fps: float = 10.0, imu_hz: float = 200.0,
                 accel_scale: float = 1.0, yaw_rate: float = 0.25, tilt=(0.06, -0.04),
                 texture: bool = False, texture_radius: float = 6.0, revisit: bool = False,
                 laps: int = 1, pixel_noise: float = 0.0, blackout: tuple | None = None,
                 device=None) -> dict:
    """Write a sequence in the reference layout (images/*.npy,
    cam_timestamps.txt, imu_data.csv, groundtruth.tum) along the tool's
    analytic trajectory (``revisit``: its closed circuit, traversed
    ``laps`` times): the frames and IMU rows of
    ``tools/make_synthetic_dataset.py`` with its IMU noise and its other
    nuisances off (gravity tilted by ``tilt``, accelerometer from the
    analytic derivative, gyro from the midpoint log of the rotation
    increments). ``pixel_noise`` adds Gaussian noise of that std to every
    frame and ``blackout=(a, b)`` renders frames [a, b) as the tool's
    sensor noise floor, both drawn from a numpy generator seeded with
    ``seed`` (not the tool's draws bit for bit). Returns the ground truth."""
    from .io import trajectory as tio
    from .solver.imu_init import gravity_dir_to_rotation

    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    pts = make_point_world(seed, points, radius=(3.0, 9.0))
    dt = 1.0 / imu_hz
    per_frame = int(round(imu_hz / fps))
    ts = np.arange((frames - 1) * per_frame + 1) * dt
    if revisit:
        p_w, _, a_w, phi = _tool_trajectory("revisit_trajectory")(ts, accel_scale, yaw_rate,
                                                                   laps=laps)
    else:
        p_w, _, a_w, phi = _tool_trajectory("analytic_trajectory")(ts, accel_scale, yaw_rate)
    r_all = lie.so3_exp(torch.as_tensor(phi, dtype=torch.float32)).numpy()

    r_wg = gravity_dir_to_rotation(torch.as_tensor(tilt, dtype=torch.float32)).numpy()
    g_w = r_wg @ np.array([0.0, 0.0, -9.81])
    rows = np.zeros((len(ts), 7), np.float64)
    rows[:, 0] = ts
    dr = np.einsum("tij,tik->tjk", r_all[:-2], r_all[2:])  # R_i^T R_{i+2}
    omega_mid = lie.so3_log(torch.as_tensor(dr)).numpy() / (2 * dt)
    rows[1:-1, 4:7] = omega_mid
    rows[0, 4:7] = omega_mid[0]
    rows[-1, 4:7] = omega_mid[-1]
    rows[:, 1:4] = np.einsum("tij,tj->ti", r_all.transpose(0, 2, 1), a_w - g_w)
    with open(os.path.join(out_dir, "imu_data.csv"), "w") as f:
        f.write("timestamp,ax,ay,az,gx,gy,gz\n")
        for row in rows:
            f.write(",".join(f"{v:.9f}" for v in row) + "\n")

    frame_idx = np.arange(frames) * per_frame
    r_wb = r_all[frame_idx]
    p_f = p_w[frame_idx].astype(np.float32)
    stamps = ts[frame_idx]
    with open(os.path.join(out_dir, "cam_timestamps.txt"), "w") as f:
        f.write("\n".join(f"{t:.6f}" for t in stamps) + "\n")
    pano = make_panorama(seed + 77, 2 * height, 2 * width, octaves=6, device=device) if texture else None
    rng = np.random.default_rng(seed)
    for k in range(frames):
        if texture:
            img = render_textured_view(pano, torch.as_tensor(r_wb[k], device=device),
                                       torch.as_tensor(p_f[k], device=device), width, height,
                                       radius=texture_radius).cpu().numpy()
        else:
            img = render_point_image(pts, r_wb[k], p_w[frame_idx[k]], width, height)
        if pixel_noise > 0:
            img = img + rng.standard_normal(img.shape).astype(np.float32) * pixel_noise
        if blackout is not None and blackout[0] <= k < blackout[1]:
            # total exposure failure: the sensor noise floor only
            img = rng.standard_normal(img.shape).astype(np.float32) * 0.01 + 0.02
        np.save(os.path.join(out_dir, "images", f"{k:06d}.npy"),
                np.clip(img, 0.0, 1.0).astype(np.float32))
    tio.write_tum(os.path.join(out_dir, "groundtruth.tum"), stamps, r_wb, p_w[frame_idx])
    return {"stamps": stamps, "r_wb": r_wb, "p_w": p_w[frame_idx]}
