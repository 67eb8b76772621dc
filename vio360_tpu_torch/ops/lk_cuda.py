"""Pyramidal Lucas-Kanade: CUDA kernel K4 + its plain twin.

Counterpart of ``vio360_tpu/ops/lk_pallas.py`` (``track`` /
``_lk_pyr_kernel``). ``track`` launches ``csrc/lk_pyr.cu`` for CUDA
tensors (all levels fused, one CTA per feature) and runs ``track_plain``
for CPU tensors. ``track_plain`` is the twin of
``vio360_tpu.ops.lk.track_xla``; the kernel follows the same semantics
(template at the previous position, Scharr gradients of the previous
image, horizontal wrap, ``bilinear_sample``'s vertical clamp, per-level
validity, eps exit), so both return (uv [N,2] with u wrapped into
[0, W), status [N] bool, err [N] mean |I-J| over the level-0 window).
The wrapper builds both pyramids (``ops/pyramid.py``) in one batched pass;
the kernel forms the template's Scharr gradients itself, the way
``template_staged`` does in plain PyTorch.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import torch

from .. import cuda_build
from ..device import check_kernel_device
from ..geometry.camera import fmod_positive
from .pyramid import build_pyramid, pyr_down, scharr_gradients
from .sampling import bilinear_sample, patch_coords

MIN_EIG_THRESHOLD = 1.5e-9  # OpenCV's 1e-4 rescaled to [0, 1] intensities
_MAX_LEVELS = 8
_MAX_HALF = 15

#: kernel launches by name ("lk_pyr")
LAUNCHES: collections.Counter = collections.Counter()


class _LevelMeta(ctypes.Structure):
    """Mirror of ``struct LkLevels`` in csrc/lk_pyr.cu."""

    _fields_ = [
        ("n_levels", ctypes.c_int),
        ("h", ctypes.c_int * _MAX_LEVELS),
        ("w", ctypes.c_int * _MAX_LEVELS),
        ("offset", ctypes.c_longlong * _MAX_LEVELS),
    ]


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {"lk_pyr": [_VP] * 8 + [ctypes.POINTER(_LevelMeta), _I, _I, _I, _F, _F, _VP]}


def _finish(uv, status, err, uv_prev, w):
    uv = torch.stack([fmod_positive(uv[:, 0], float(w)), uv[:, 1]], -1)
    return torch.where(status[:, None], uv, uv_prev), status, err


def _track_level(img_i, img_j, grad_ix, grad_iy, uv_i, uv_j, valid, half_win, iters, eps,
                 min_eig_threshold=MIN_EIG_THRESHOLD):
    """One pyramid level for all features (twin of ``lk._track_level``)."""
    h = img_i.shape[0]
    coords = patch_coords(uv_i, half_win)
    t = bilinear_sample(img_i, coords)
    gx = bilinear_sample(grad_ix, coords)
    gy = bilinear_sample(grad_iy, coords)
    gxx, gxy, gyy = (gx * gx).sum(-1), (gx * gy).sum(-1), (gy * gy).sum(-1)
    det = gxx * gyy - gxy * gxy
    npix = float((2 * half_win + 1) ** 2)
    min_eig = 0.5 * (gxx + gyy - torch.sqrt((gxx - gyy) ** 2 + 4.0 * gxy * gxy)) / npix
    ok_g = (min_eig > min_eig_threshold) & (det > 1e-12)
    safe_det = torch.where(ok_g, det, torch.ones_like(det))
    inv00, inv01, inv11 = gyy / safe_det, -gxy / safe_det, gxx / safe_det
    ok_t = (uv_i[:, 1] >= 0.0) & (uv_i[:, 1] <= h - 1.0)
    valid = valid & ok_g & ok_t
    active = valid
    uv = uv_j
    eps2 = torch.tensor(eps * eps, dtype=torch.float32, device=uv_j.device)
    for _ in range(iters):
        if not bool(active.any()):
            break  # every remaining step is masked: same result as the full ladder
        diff = bilinear_sample(img_j, patch_coords(uv, half_win)) - t
        b0, b1 = (diff * gx).sum(-1), (diff * gy).sum(-1)
        delta = torch.stack([-(inv00 * b0 + inv01 * b1), -(inv01 * b0 + inv11 * b1)], -1)
        uv = uv + torch.where(active[:, None], delta, torch.zeros_like(delta))
        active = active & ((delta * delta).sum(-1) >= eps2)
    ok_j = (uv[:, 1] >= 0.0) & (uv[:, 1] <= h - 1.0)
    return uv, valid & ok_j & torch.isfinite(uv).all(-1)


def track_plain(img_prev, img_next, uv_prev, valid_in, uv_guess=None, num_levels=3,
                half_win=10, iters=30, eps=0.01):
    """Twin of ``vio360_tpu.ops.lk.track_xla``."""
    w = img_prev.shape[1]
    pyr_i = build_pyramid(img_prev, num_levels)
    pyr_j = build_pyramid(img_next, num_levels)
    grads = [scharr_gradients(im) for im in pyr_i]
    uv = uv_prev if uv_guess is None else uv_guess
    status = valid_in
    for lvl in range(num_levels, -1, -1):
        s = 1.0 / (2.0 ** lvl)
        uv_l, status = _track_level(pyr_i[lvl], pyr_j[lvl], grads[lvl][0], grads[lvl][1],
                                    uv_prev * s, uv * s, status, half_win, iters, eps)
        uv = uv_l / s
    err = (bilinear_sample(img_next, patch_coords(uv, half_win))
           - bilinear_sample(img_prev, patch_coords(uv_prev, half_win))).abs().mean(-1)
    return _finish(uv, status, err, uv_prev, w)


def template_staged(img, uv, half_win):
    """A level's template and Scharr gradients the way K4 forms them, for
    the tests: the (p+3)^2 integer neighbourhood of ``img`` [H, W] around
    each centre of ``uv`` [N, 2], Scharr at the (p+1)^2 integer positions
    (patch row r is image row clamp(v0 + r), its neighbours rows
    clamp(clamp(v0 + r) +- 1)), then every window pixel interpolated with
    the centre's one fractional offset. -> (t, gx, gy), each [N, (2h+1)^2]
    in ``patch_offsets`` order; equal, up to rounding, to
    ``bilinear_sample`` of the image and of its ``scharr_gradients``."""
    h, w = img.shape
    p = 2 * half_win + 1
    n = uv.shape[0]
    fu, fv = torch.floor(uv[:, 0]), torch.floor(uv[:, 1])
    au, av = (uv[:, 0] - fu)[:, None, None], (uv[:, 1] - fv)[:, None, None]
    u0 = fu.to(torch.int64) - half_win
    v0 = fv.to(torch.int64) - half_win
    v0c = v0.clamp(0, h - 1)
    ar = lambda m: torch.arange(m, device=img.device)
    # neighbourhood nb[n, q, c] = img[clamp(v0c - 1 + q), (u0 - 1 + c) mod w]
    rows = (v0c[:, None] - 1 + ar(p + 3)).clamp(0, h - 1)
    cols = torch.remainder(u0[:, None] - 1 + ar(p + 3), w)
    nb = img[rows[:, :, None], cols[:, None, :]]
    big_r = (v0c[:, None] + ar(p + 1)).clamp(max=h - 1)  # image row of patch row r
    pick = lambda rr: nb.gather(1, (rr - v0c[:, None] + 1)[:, :, None].expand(n, p + 1, p + 3))
    r_m, r_u, r_d = pick(big_r), pick((big_r - 1).clamp(min=0)), pick((big_r + 1).clamp(max=h - 1))
    s0, s1, s2 = 3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0
    sv = s0 * r_u + s1 * r_m + s2 * r_d
    sh = lambda x: s0 * x[..., 0:p + 1] + s1 * x[..., 1:p + 2] + s2 * x[..., 2:p + 3]
    integer = (r_m[..., 1:p + 2], 0.5 * (sv[..., 2:] - sv[..., :-2]), 0.5 * (sh(r_d) - sh(r_u)))
    # window row k interpolates patch rows clamp(v0 + k) - v0c and the next
    top = ((v0[:, None] + ar(p)).clamp(0, h - 1) - v0c[:, None])[:, :, None].expand(n, p, p + 1)
    out = []
    for x in integer:
        a, b = x.gather(1, top), x.gather(1, top + 1)
        upper = a[..., :p] * (1.0 - au) + a[..., 1:] * au
        lower = b[..., :p] * (1.0 - au) + b[..., 1:] * au
        out.append((upper * (1.0 - av) + lower * av).reshape(n, p * p))
    return tuple(out)


@dataclasses.dataclass
class Prepared:
    """K4's inputs on the card: both images' pyramids in one flat buffer
    (level l of the previous image, then level l of the next, for each
    level), its level table, and the feature arrays."""

    pyr: torch.Tensor
    meta: _LevelMeta
    uv_prev: torch.Tensor
    uv_guess: torch.Tensor
    valid: torch.Tensor


def prepare(img_prev, img_next, uv_prev, valid_in, uv_guess=None, num_levels=3) -> Prepared:
    """Everything ``track`` does on the card before K4's launch: checks and
    both pyramids, built in one batched pass over the [2, H, W] stack
    straight into the flat buffer."""
    dev = img_prev.device
    n = uv_prev.shape[0]
    if img_prev.dim() != 2 or img_next.shape != img_prev.shape:
        raise ValueError("lk_pyr: images must be equal-size [H, W]")
    if uv_prev.shape != (n, 2) or valid_in.shape != (n,):
        raise ValueError("lk_pyr: uv_prev [N, 2] and valid_in [N] expected")
    if not 0 <= num_levels < _MAX_LEVELS:
        raise ValueError(f"lk_pyr: num_levels {num_levels} out of range")
    for name, t in dict(img_next=img_next, uv_prev=uv_prev, valid_in=valid_in).items():
        if t.device != dev:
            raise ValueError(f"lk_pyr: {name} on {t.device}, expected {dev}")
    meta = _LevelMeta()
    meta.n_levels = num_levels + 1
    h, w = img_prev.shape
    off = 0
    for lvl in range(num_levels + 1):
        meta.h[lvl], meta.w[lvl], meta.offset[lvl] = h, w, off
        off += 2 * h * w
        h, w = (h + 1) // 2, (w + 1) // 2
    pyr = torch.empty(off, dtype=torch.float32, device=dev)
    levels = [pyr[meta.offset[lvl]:meta.offset[lvl] + 2 * meta.h[lvl] * meta.w[lvl]]
              .view(2, meta.h[lvl], meta.w[lvl]) for lvl in range(num_levels + 1)]
    torch.stack([img_prev, img_next], out=levels[0])
    for lvl in range(num_levels):
        pyr_down(levels[lvl], out=levels[lvl + 1])
    return Prepared(
        pyr=pyr, meta=meta, uv_prev=uv_prev.to(torch.float32).contiguous(),
        uv_guess=(uv_prev if uv_guess is None else uv_guess).to(torch.float32).contiguous(),
        valid=valid_in.to(torch.bool).contiguous(),
    )


def launch(prep: Prepared, half_win=10, iters=30, eps=0.01, work: torch.Tensor | None = None):
    """K4 alone on prepared buffers -> (uv, status, err) as ``track``.
    ``work``, an [N, 3] int32 tensor, receives each feature's Gauss-Newton
    steps, templates formed and J patches staged, over all levels."""
    if not 1 <= half_win <= _MAX_HALF:
        raise ValueError(f"lk_pyr: half_win {half_win} out of range")
    dev = prep.uv_prev.device
    n = prep.uv_prev.shape[0]
    if work is not None and (work.shape != (n, 3) or work.dtype != torch.int32
                             or work.device != dev or not work.is_contiguous()):
        raise ValueError("lk_pyr: work must be a contiguous [N, 3] int32 tensor on the card")
    uv_out = torch.empty(n, 2, dtype=torch.float32, device=dev)
    status = torch.empty(n, dtype=torch.bool, device=dev)
    err = torch.empty(n, dtype=torch.float32, device=dev)
    lib = cuda_build.load("lk_pyr", _SIGS)
    ptr = cuda_build.ptr
    rc = lib.lk_pyr(
        ptr(prep.pyr), ptr(prep.uv_prev), ptr(prep.uv_guess), ptr(prep.valid), ptr(uv_out),
        ptr(status), ptr(err), None if work is None else ptr(work), ctypes.byref(prep.meta), n,
        half_win, iters, float(eps * eps), MIN_EIG_THRESHOLD, cuda_build.stream_ptr(dev),
    )
    cuda_build.check(rc, "lk_pyr launch")
    LAUNCHES["lk_pyr"] += 1
    return uv_out, status, err


def track(img_prev, img_next, uv_prev, valid_in, uv_guess=None, num_levels=3, half_win=10,
          iters=30, eps=0.01):
    """K4 on CUDA tensors (``prepare`` then ``launch``), ``track_plain``
    on CPU tensors."""
    if not check_kernel_device(img_prev, "lk track"):
        return track_plain(img_prev, img_next, uv_prev, valid_in, uv_guess, num_levels,
                           half_win, iters, eps)
    return launch(prepare(img_prev, img_next, uv_prev, valid_in, uv_guess, num_levels), half_win,
                  iters, eps)
