"""ERP-native place recognition primitives.

Counterpart of ``vio360_tpu/loop/descriptor.py``: the ring descriptor
(latitude bands x longitude bins of intensity and horizontal gradient
energy, smoothed, per-band normalized), whose similarity under an unknown
yaw is a circular cross-correlation evaluated for every shift as one
matrix product, and 8x8 zero-mean unit-norm bilinear patches around the
tracked features, matched by mutual-nearest NCC as one matrix product.
Plain PyTorch (``torch.matmul`` for the products), as the reference left
them to XLA outside Pallas.
"""

from __future__ import annotations

import math

import torch

from ..ops import pyramid


def ring_descriptor(image: torch.Tensor, bands: int, bins: int) -> torch.Tensor:
    """[H,W] ERP intensity image -> [2, bands, bins] descriptor (channel
    0 mean intensity, channel 1 mean |horizontal gradient|; smoothed
    circularly in longitude and edge-clamped in latitude; each (channel,
    band) row zero-mean and unit-norm; the whole scaled so a full
    correlation lies in [-1, 1])."""
    h, w = image.shape
    assert h % bands == 0 and w % bins == 0, (h, w, bands, bins)
    gx = torch.roll(image, -1, 1) - torch.roll(image, 1, 1)

    def pool(img):
        return img.reshape(bands, h // bands, bins, w // bins).mean((1, 3))

    d = torch.stack([pool(image), pool(torch.abs(gx))])  # [2,B,L]
    for _ in range(4):  # [1,2,1]/4 passes, circular in longitude
        d = 0.5 * d + 0.25 * (torch.roll(d, 1, 2) + torch.roll(d, -1, 2))
    for _ in range(2):  # the same along latitude, edge-clamped
        pad = torch.cat([d[:, :1], d, d[:, -1:]], 1)
        d = 0.5 * d + 0.25 * (pad[:, :-2] + pad[:, 2:])
    d = d - d.mean(2, keepdim=True)
    d = d / (torch.linalg.norm(d, dim=2, keepdim=True) + 1e-6)
    return d / math.sqrt(float(2.0 * bands))


def score_all_shifts(desc_q: torch.Tensor, desc_db: torch.Tensor) -> tuple:
    """desc_q [2,B,L], desc_db [N,2,B,L] -> (scores [N], shifts [N]): the
    best correlation over all L longitude shifts and the shift taking it
    (argmax: the first of equal maxima)."""
    n, l = desc_db.shape[0], desc_q.shape[-1]
    shifted = torch.stack([torch.roll(desc_q, s, -1) for s in range(l)])  # [L,2,B,L]
    corr = desc_db.reshape(n, -1) @ shifted.reshape(l, -1).T  # [N,L]
    best = corr.max(1).values
    return best, first_argmax(corr, 1)


def first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (jnp.argmax's tie rule;
    torch.argmax promises none), int32."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device).reshape([-1 if d == dim % x.dim() else 1
                                                     for d in range(x.dim())])
    at_max = x == x.amax(dim, keepdim=True)
    return torch.where(at_max, idx, torch.full_like(idx, n)).amin(dim).to(torch.int32)


def extract_patches(image: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor, size: int,
                    levels: int = 0) -> torch.Tensor:
    """[C, size*size] zero-mean unit-norm bilinear patches around ``uv``
    (horizontal wrap, vertical clamp), after ``levels`` pyramid levels
    (uv scaled to match); invalid slots give zero rows."""
    for _ in range(levels):
        image = pyramid.pyr_down(image)
    if levels:
        uv = uv / float(2 ** levels)
    h, w = image.shape
    c = uv.shape[0]
    off = torch.arange(size, dtype=torch.float32, device=uv.device) - (size - 1) / 2.0
    ys = (uv[:, 1, None, None] + off[None, :, None]).expand(c, size, size)
    xs = (uv[:, 0, None, None] + off[None, None, :]).expand(c, size, size)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0

    def sample(yi, xi):
        yi = torch.clamp(yi, 0, h - 1).long()
        xi = torch.remainder(xi, w).long()  # horizontal wrap (jnp.mod)
        return image[yi, xi]

    p = (sample(y0, x0) * (1 - fy) * (1 - fx) + sample(y0, x0 + 1) * (1 - fy) * fx
         + sample(y0 + 1, x0) * fy * (1 - fx) + sample(y0 + 1, x0 + 1) * fy * fx)
    p = p.reshape(c, size * size)
    p = p - p.mean(1, keepdim=True)
    p = p / (torch.linalg.norm(p, dim=1, keepdim=True) + 1e-6)
    return torch.where(valid[:, None], p, torch.zeros_like(p))


def match_patches(pq: torch.Tensor, vq: torch.Tensor, pc: torch.Tensor, vc: torch.Tensor,
                  min_ncc: float, min_margin: float) -> tuple:
    """Mutual-nearest NCC matching of query patches pq [...,C,P] against
    candidate patches pc [...,C,P] (any leading batch dims): (match_idx
    [...,C] into candidate slots or -1, best score [...,C])."""
    s = pq @ pc.transpose(-1, -2)  # [...,C,C] NCC in [-1, 1]
    neg = torch.tensor(-2.0, dtype=s.dtype, device=s.device)
    s = torch.where(vq[..., :, None] & vc[..., None, :], s, neg)
    best_j = first_argmax(s, -1)
    s1 = s.amax(-1)
    s_wo = s.scatter(-1, best_j[..., None].long(), neg.expand_as(s[..., :1]))  # second best
    s2 = s_wo.amax(-1)
    best_i_of_j = first_argmax(s, -2)  # the candidate's best query
    mutual = torch.gather(best_i_of_j, -1, best_j.long()) == torch.arange(
        s.shape[-2], dtype=torch.int32, device=s.device)
    accept = vq & (s1 >= min_ncc) & (s1 - s2 >= min_margin) & mutual
    return torch.where(accept, best_j, torch.full_like(best_j, -1)), s1
