"""Pyramidal Lucas-Kanade: CUDA kernel K4 + its plain twin.

Counterpart of ``vio360_tpu/ops/lk_pallas.py`` (``track`` /
``_lk_pyr_kernel``). ``track`` launches ``csrc/lk_pyr.cu`` for CUDA
tensors (all levels fused, one warp per feature) and runs
``track_plain`` for CPU tensors. ``track_plain`` is the twin of
``vio360_tpu.ops.lk.track_xla``; the kernel follows the same semantics
(template at the previous position, Scharr gradients of the previous
image, horizontal wrap, ``bilinear_sample``'s vertical clamp, per-level
validity, eps exit), so both return (uv [N,2] with u wrapped into
[0, W), status [N] bool, err [N] mean |I-J| over the level-0 window).
The pyramid and gradient images are built outside the kernel with
``ops/pyramid.py``, as XLA did around the JAX LK.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import torch

from .. import cuda_build
from ..device import check_kernel_device
from ..geometry.camera import fmod_positive
from .pyramid import build_pyramid, scharr_gradients
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
_SIGS = {"lk_pyr": [_VP] * 10 + [ctypes.POINTER(_LevelMeta), _I, _I, _I, _F, _F, _VP]}


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


def _flat(levels: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([lv.reshape(-1) for lv in levels]).contiguous()


@dataclasses.dataclass
class Prepared:
    """K4's inputs on the card: the flattened pyramids of both images and
    the previous image's Scharr gradients, their level table, and the
    feature arrays."""

    buf_i: torch.Tensor
    buf_j: torch.Tensor
    buf_gx: torch.Tensor
    buf_gy: torch.Tensor
    meta: _LevelMeta
    uv_prev: torch.Tensor
    uv_guess: torch.Tensor
    valid: torch.Tensor
    width: int


def prepare(img_prev, img_next, uv_prev, valid_in, uv_guess=None, num_levels=3) -> Prepared:
    """Everything ``track`` does on the card before K4's launch: checks,
    pyramids, gradients and the flat level buffers."""
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
    img_prev = img_prev.to(torch.float32).contiguous()
    img_next = img_next.to(torch.float32).contiguous()
    pyr_i = build_pyramid(img_prev, num_levels)
    pyr_j = build_pyramid(img_next, num_levels)
    grads = [scharr_gradients(im) for im in pyr_i]
    meta = _LevelMeta()
    meta.n_levels = num_levels + 1
    off = 0
    for lvl, im in enumerate(pyr_i):
        meta.h[lvl], meta.w[lvl], meta.offset[lvl] = im.shape[0], im.shape[1], off
        off += im.numel()
    return Prepared(
        buf_i=_flat(pyr_i), buf_j=_flat(pyr_j), buf_gx=_flat([g[0] for g in grads]),
        buf_gy=_flat([g[1] for g in grads]), meta=meta,
        uv_prev=uv_prev.to(torch.float32).contiguous(),
        uv_guess=(uv_prev if uv_guess is None else uv_guess).to(torch.float32).contiguous(),
        valid=valid_in.to(torch.bool).contiguous(), width=img_prev.shape[1],
    )


def launch(prep: Prepared, half_win=10, iters=30, eps=0.01):
    """K4 alone on prepared buffers -> (uv, status, err) as ``track``."""
    if not 1 <= half_win <= _MAX_HALF:
        raise ValueError(f"lk_pyr: half_win {half_win} out of range")
    dev = prep.uv_prev.device
    n = prep.uv_prev.shape[0]
    uv_out = torch.empty(n, 2, dtype=torch.float32, device=dev)
    status = torch.empty(n, dtype=torch.bool, device=dev)
    err = torch.empty(n, dtype=torch.float32, device=dev)
    lib = cuda_build.load("lk_pyr", _SIGS)
    ptr = cuda_build.ptr
    rc = lib.lk_pyr(
        ptr(prep.buf_i), ptr(prep.buf_j), ptr(prep.buf_gx), ptr(prep.buf_gy), ptr(prep.uv_prev),
        ptr(prep.uv_guess), ptr(prep.valid), ptr(uv_out), ptr(status), ptr(err),
        ctypes.byref(prep.meta), n, half_win, iters, float(eps * eps), MIN_EIG_THRESHOLD,
        cuda_build.stream_ptr(dev),
    )
    cuda_build.check(rc, "lk_pyr launch")
    LAUNCHES["lk_pyr"] += 1
    return _finish(uv_out, status, err, prep.uv_prev, prep.width)


def track(img_prev, img_next, uv_prev, valid_in, uv_guess=None, num_levels=3, half_win=10,
          iters=30, eps=0.01):
    """K4 on CUDA tensors (``prepare`` then ``launch``), ``track_plain``
    on CPU tensors."""
    if not check_kernel_device(img_prev, "lk track"):
        return track_plain(img_prev, img_next, uv_prev, valid_in, uv_guess, num_levels,
                           half_win, iters, eps)
    return launch(prepare(img_prev, img_next, uv_prev, valid_in, uv_guess, num_levels), half_win,
                  iters, eps)
