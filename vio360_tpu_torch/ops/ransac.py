"""Batched RANSAC: rotation-only (tracking) and essential (init).

Counterpart of ``vio360_tpu/ops/ransac.py``. Each estimator is split
into sampling (``sample_valid``, driven by a ``torch.Generator``) and
scoring (``*_score``, a pure function of the drawn indices), so a test
can hand the scoring the exact indices the JAX sampler drew from its
PRNG key. All hypotheses are scored as one batch; hypotheses touching
an invalid or duplicated index are degenerate rather than resampled.
"""

from __future__ import annotations

import math

import torch

from ..geometry.essential import enforce_rank2, epipolar_errors, solve_eight_point


def compact_indices(mask: torch.Tensor, fill: int) -> torch.Tensor:
    """Fixed-size ``jnp.nonzero(mask, size=n, fill_value=fill)``: the
    indices of True entries in order, then ``fill``; no host sync."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    dest = torch.where(mask, pos, torch.full_like(pos, n))  # n = dropped
    out = torch.full((n + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dest, torch.arange(n, device=mask.device))
    return out[:n]


def sample_valid(gen: torch.Generator, valid: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Indices drawn uniformly from the VALID entries (fixed shape)."""
    valid_idx = compact_indices(valid, 0)
    n_valid = torch.clamp(valid.sum(), min=1)
    u = torch.rand(shape, generator=gen, device=valid.device)
    ranks = torch.minimum((u * n_valid).to(torch.int64), n_valid - 1)
    return valid_idx[ranks]


def _kabsch_rotation(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Best R with b2 ~= R b1 from paired unit vectors [..., S, 3]."""
    h = b1.transpose(-1, -2) @ b2
    u, _, vt = torch.linalg.svd(h)
    d = torch.linalg.det(vt.transpose(-1, -2) @ u.transpose(-1, -2))
    s = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    return vt.transpose(-1, -2) @ s @ u.transpose(-1, -2)


def rotation_ransac_score(idx, bearings_prev, bearings_curr, valid, threshold_rad):
    """Score hypotheses idx [I, 3] -> (R_best [3,3], inlier_mask [N], num_inliers)."""
    samp_ok = valid[idx].all(-1)
    samp_ok &= (idx[:, 0] != idx[:, 1]) & (idx[:, 0] != idx[:, 2]) & (idx[:, 1] != idx[:, 2])
    rs = _kabsch_rotation(bearings_prev[idx], bearings_curr[idx])
    rotated = torch.einsum("kij,nj->kni", rs, bearings_prev)
    cosang = torch.clamp((rotated * bearings_curr[None]).sum(-1), -1.0, 1.0)
    inl = (torch.arccos(cosang) < threshold_rad) & valid[None, :]
    counts = torch.where(samp_ok, inl.sum(-1), torch.full_like(samp_ok, -1, dtype=torch.int64))
    best = torch.argmax(counts)
    return rs[best], inl[best], counts[best]


def rotation_ransac(gen, bearings_prev, bearings_curr, valid,
                    threshold_rad: float = math.radians(2.0), iterations: int = 1000):
    """-> (R_best [3,3] prev->curr, inlier_mask [N], num_inliers)."""
    idx = sample_valid(gen, valid, (iterations, 3))
    return rotation_ransac_score(idx, bearings_prev, bearings_curr, valid, threshold_rad)


def essential_ransac_score(idx, bearings1, bearings2, valid, threshold):
    """Score hypotheses idx [I, 8] -> (E refit on best inliers, mask, count)."""
    samp_ok = valid[idx].all(-1)
    dup = (idx[:, :, None] == idx[:, None, :]).sum((1, 2)) > 8
    samp_ok &= ~dup
    e_hyp = solve_eight_point(bearings1[idx], bearings2[idx])
    errs = epipolar_errors(e_hyp, bearings1, bearings2)
    inl = (errs < threshold) & valid[None, :]
    counts = torch.where(samp_ok, inl.sum(-1), torch.full_like(samp_ok, -1, dtype=torch.int64))
    best = torch.argmax(counts)
    best_mask = inl[best]
    e_refit = enforce_rank2(solve_eight_point(bearings1, bearings2, weights=best_mask.to(bearings1.dtype)))
    return e_refit, best_mask, counts[best]


def essential_ransac(gen, bearings1, bearings2, valid, threshold: float = 0.1,
                     iterations: int = 200):
    """-> (E [3,3] refit on best inliers, inlier_mask [N], num_inliers)."""
    idx = sample_valid(gen, valid, (iterations, 8))
    return essential_ransac_score(idx, bearings1, bearings2, valid, threshold)
