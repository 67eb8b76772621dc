"""On-manifold IMU preintegration (Forster RSS'15).

Counterpart of ``vio360_tpu/imu/preintegration.py``: delta rotation /
velocity / position between two camera times, first-order bias
Jacobians (the standard Forster recursions), the 15x15 covariance with
the full A/B propagation, bias re-linearization without re-integration,
state prediction and the static-bias estimate.

The JAX ``preintegrate`` scans a fixed [S, 7] buffer under a prefix
mask. Here the caller passes the valid rows only (every caller knows
their count on the host): masked rows leave the JAX carry unchanged, so
the result is the same. What does not depend on the carry (per-sample
dt, the rotation increments and their right Jacobians) is computed for
all rows at once; the recursion is a Python loop over the rows.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie


@dataclasses.dataclass
class Preintegration:
    """Fields may carry a leading batch axis (stacked keyframe pairs)."""

    delta_r: torch.Tensor  # [..., 3, 3]
    delta_v: torch.Tensor  # [..., 3]
    delta_p: torch.Tensor  # [..., 3]
    j_rg: torch.Tensor  # [..., 3, 3] d(delta_r)/d(gyro bias)
    j_vg: torch.Tensor
    j_va: torch.Tensor
    j_pg: torch.Tensor
    j_pa: torch.Tensor
    cov: torch.Tensor  # [..., 15, 15] (theta, v, p, bg, ba)
    bg: torch.Tensor  # [..., 3] bias used during integration
    ba: torch.Tensor
    dt_total: torch.Tensor  # [...]
    n_samples: torch.Tensor  # [...] int32

    def map(self, fn) -> "Preintegration":
        return Preintegration(**{f.name: fn(getattr(self, f.name))
                                 for f in dataclasses.fields(self)})


def stack(pres: list[Preintegration]) -> Preintegration:
    return Preintegration(**{f.name: torch.stack([getattr(p, f.name) for p in pres])
                             for f in dataclasses.fields(Preintegration)})


def identity_preintegration(device=None) -> Preintegration:
    z33 = torch.zeros(3, 3, device=device)
    z3 = torch.zeros(3, device=device)
    return Preintegration(
        delta_r=torch.eye(3, device=device), delta_v=z3, delta_p=z3, j_rg=z33, j_vg=z33,
        j_va=z33, j_pg=z33, j_pa=z33, cov=torch.zeros(15, 15, device=device), bg=z3, ba=z3,
        dt_total=torch.zeros((), device=device),
        n_samples=torch.zeros((), dtype=torch.int32, device=device),
    )


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m @ v[..., None])[..., 0]


def preintegrate(samples: torch.Tensor, bg: torch.Tensor, ba: torch.Tensor,
                 gyro_noise: float = 0.001, accel_noise: float = 0.01,
                 gyro_bias_noise: float = 1e-4, accel_bias_noise: float = 1e-3,
                 min_dt: float = 0.0005, max_dt: float = 0.02,
                 default_dt: float = 0.002) -> Preintegration:
    """Integrate the rows of ``samples`` [S, 7] (t, ax, ay, az, gx, gy, gz),
    all valid. dt[i] = t[i] - t[i-1], the first sample t[1] - t[0] (or
    ``default_dt`` for a single sample), clamped to [min_dt, max_dt]."""
    dev = samples.device
    out = dataclasses.replace(identity_preintegration(dev), bg=bg, ba=ba)
    s = samples.shape[0]
    if s == 0:
        return out
    t = samples[:, 0]
    dts = torch.cat([t[1:2] - t[0:1] if s > 1 else torch.full((1,), default_dt, device=dev),
                     t[1:] - t[:-1]])
    dts = torch.clamp(dts, min_dt, max_dt)
    acc = samples[:, 1:4] - ba
    omega_dt = (samples[:, 4:7] - bg) * dts[:, None]
    drs, jrs, a_hats = lie.so3_exp(omega_dt), lie.so3_right_jacobian(omega_dt), lie.hat(acc)

    sg2, sa2 = gyro_noise * gyro_noise, accel_noise * accel_noise
    walk_rate = torch.tensor([gyro_bias_noise ** 2] * 3 + [accel_bias_noise ** 2] * 3, device=dev)
    noise = torch.tensor([sg2] * 3 + [sa2] * 3, device=dev)
    eye3, z = torch.eye(3, device=dev), torch.zeros(3, 3, device=dev)
    r, dv, dp = out.delta_r, out.delta_v, out.delta_p
    j_rg, j_vg, j_va, j_pg, j_pa = out.j_rg, out.j_vg, out.j_va, out.j_pg, out.j_pa
    cov, dt_total = out.cov, out.dt_total
    for i in range(s):
        dt, dr, jr = dts[i], drs[i], jrs[i]
        ra = r @ a_hats[i]
        # Forster bias-Jacobian recursions (old values on the right)
        j_pg = j_pg + j_vg * dt - 0.5 * (ra @ j_rg) * dt * dt
        j_pa = j_pa + j_va * dt - 0.5 * r * dt * dt
        j_vg = j_vg - (ra @ j_rg) * dt
        j_va = j_va - r * dt
        j_rg = dr.T @ j_rg - jr * dt
        r_acc = _mv(r, acc[i])
        dp = dp + dv * dt + 0.5 * r_acc * dt * dt
        dv = dv + r_acc * dt
        # covariance: full Forster A / B on the (theta, v, p) block
        a_mat = torch.cat([
            torch.cat([dr.T, z, z], 1),
            torch.cat([-ra * dt, eye3, z], 1),
            torch.cat([-0.5 * ra * dt * dt, eye3 * dt, eye3], 1),
        ], 0)
        b_mat = torch.cat([
            torch.cat([jr * dt, z], 1),
            torch.cat([z, r * dt], 1),
            torch.cat([z, 0.5 * r * dt * dt], 1),
        ], 0)
        cov9 = a_mat @ cov[:9, :9] @ a_mat.T + (b_mat * noise) @ b_mat.T
        cov = torch.block_diag(cov9, cov[9:, 9:] + torch.diag(walk_rate * dt))
        r = r @ dr
        dt_total = dt_total + dt
    return Preintegration(
        delta_r=r, delta_v=dv, delta_p=dp, j_rg=j_rg, j_vg=j_vg, j_va=j_va, j_pg=j_pg, j_pa=j_pa,
        cov=cov, bg=bg, ba=ba, dt_total=dt_total,
        n_samples=torch.tensor(s, dtype=torch.int32, device=dev),
    )


def update_bias(preint: Preintegration, new_bg: torch.Tensor, new_ba: torch.Tensor) -> Preintegration:
    """First-order re-linearization at a new bias (any leading batch axis)."""
    dbg = new_bg - preint.bg
    dba = new_ba - preint.ba
    return dataclasses.replace(
        preint,
        delta_r=preint.delta_r @ lie.so3_exp(_mv(preint.j_rg, dbg)),
        delta_v=preint.delta_v + _mv(preint.j_vg, dbg) + _mv(preint.j_va, dba),
        delta_p=preint.delta_p + _mv(preint.j_pg, dbg) + _mv(preint.j_pa, dba),
        bg=new_bg.expand_as(preint.bg), ba=new_ba.expand_as(preint.ba),
    )


def predict_state(r_i, t_i, v_i, preint: Preintegration, gravity_w):
    """R_j = R_i dR; v_j = v_i + g dt + R_i dV; p_j = p_i + v_i dt + g dt^2/2 + R_i dP."""
    dt = preint.dt_total
    r_j = r_i @ preint.delta_r
    v_j = v_i + gravity_w * dt + r_i @ preint.delta_v
    p_j = t_i + v_i * dt + 0.5 * gravity_w * dt * dt + r_i @ preint.delta_p
    return r_j, p_j, v_j


def estimate_static_bias(samples: torch.Tensor, mask: torch.Tensor, gravity_magnitude: float = 9.81):
    """Stationary bias estimate: gyro bias = mean gyro; accel bias = mean
    accel minus the gravity reaction along it. Returns (bg, ba, g_dir_body)."""
    wsum = torch.clamp(mask.sum(), min=1)
    mean = torch.where(mask[:, None], samples[:, 1:7], torch.zeros_like(samples[:, 1:7])).sum(0) / wsum
    mean_acc, mean_gyr = mean[:3], mean[3:]
    g_dir = mean_acc / torch.clamp(torch.linalg.norm(mean_acc), min=1e-9)
    return mean_gyr, mean_acc - g_dir * gravity_magnitude, g_dir


def append(stacked: Preintegration, new: Preintegration, idx: int, evict: bool) -> Preintegration:
    """Put ``new`` at pair slot ``idx``; when ``evict`` the window just
    rolled, so pair 0 leaves and the stack shifts left first."""
    rolled = stacked.map(lambda a: torch.roll(a, -1, 0)) if evict else stacked

    def put(a, v):
        a = a.clone()
        a[idx] = v
        return a

    return Preintegration(**{f.name: put(getattr(rolled, f.name), getattr(new, f.name))
                             for f in dataclasses.fields(Preintegration)})


def pair_valid_mask(stacked: Preintegration, n_real: int) -> torch.Tensor:
    """[P] validity: within the live pair count, dt in (0.001, 2.0) s."""
    dt = stacked.dt_total
    return (torch.arange(dt.shape[0], device=dt.device) < n_real) & (dt > 0.001) & (dt < 2.0)


def preintegrate_cfg(samples: torch.Tensor, bg, ba, icfg) -> Preintegration:
    """``preintegrate`` with the noise densities and dt clamp of an ImuConfig."""
    return preintegrate(samples, bg, ba, gyro_noise=icfg.gyro_noise, accel_noise=icfg.accel_noise,
                        gyro_bias_noise=icfg.gyro_bias_noise,
                        accel_bias_noise=icfg.accel_bias_noise, min_dt=icfg.min_dt,
                        max_dt=icfg.max_dt)
