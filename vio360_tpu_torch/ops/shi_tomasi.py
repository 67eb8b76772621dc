"""Shi-Tomasi corner detection with max-pool NMS and top-K selection.

Counterpart of ``vio360_tpu/ops/shi_tomasi.py``. Ranking uses a stable
descending sort, so equal scores keep index order exactly as
``jax.lax.top_k`` does and the selected set never depends on ties.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .pyramid import scharr_gradients


def response_map(img: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Min-eigenvalue response [H, W] of the 2x2 structure tensor."""
    ix, iy = scharr_gradients(img)
    r = block_size // 2
    h, w = img.shape

    def box(a):
        p = torch.cat([a[:, -r:], a, a[:, :r]], 1)
        p = torch.cat([p[:1].expand(r, -1), p, p[-1:].expand(r, -1)], 0)
        c = F.pad(torch.cumsum(torch.cumsum(p, 0), 1), (1, 0, 1, 0))
        k = block_size
        return c[k:k + h, k:k + w] - c[0:h, k:k + w] - c[k:k + h, 0:w] + c[0:h, 0:w]

    sxx, sxy, syy = box(ix * ix), box(ix * iy), box(iy * iy)
    rad = torch.sqrt(torch.clamp(0.25 * (sxx - syy) ** 2 + sxy * sxy, min=0.0))
    return 0.5 * (sxx + syy) - rad


def _maxpool_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """Max-pool with SAME padding, wrap in u."""
    r = window // 2
    p = torch.cat([x[:, -r:], x, x[:, :r]], 1)
    return F.max_pool2d(p[None, None], window, stride=1, padding=(r, 0))[0, 0]


def detect(img, allowed_mask, existing_uv, existing_valid, max_new: int,
           min_distance: float = 30.0, quality_level: float = 0.01):
    """-> (uv [max_new, 2], score [max_new], valid [max_new])."""
    h, w = img.shape
    resp = torch.where(allowed_mask, response_map(img), torch.zeros((), device=img.device))
    window = int(2 * (min_distance // 2) + 1)
    peaks = (resp >= _maxpool_same(resp, window)) & (resp > 0)
    peaks &= resp > quality_level * resp.max()
    score = torch.where(peaks, resp, torch.full((), -1.0, device=img.device)).reshape(-1)
    flat_scores, flat_idx = torch.sort(score, descending=True, stable=True)
    flat_scores, flat_idx = flat_scores[:max_new], flat_idx[:max_new]
    cand_uv = torch.stack([(flat_idx % w).float(), (flat_idx // w).float()], -1)
    cand_valid = flat_scores > 0
    du = torch.abs(cand_uv[:, None, 0] - existing_uv[None, :, 0])
    du = torch.minimum(du, w - du)
    dv = cand_uv[:, None, 1] - existing_uv[None, :, 1]
    d2 = torch.where(existing_valid[None, :], du * du + dv * dv, torch.full((), float("inf"), device=img.device))
    cand_valid &= d2.min(1).values >= min_distance * min_distance
    return cand_uv, flat_scores, cand_valid
