"""Matmul-gather pyramidal Lucas-Kanade (the LK the JAX package ran on its TPU).

Counterpart of ``vio360_tpu/ops/lk_matmul.py``, with the same contract
as ``ops/lk.py::track``:

- pyramid levels of both frames from the fused banded operators
  (``_pyr_device_build``): one left matmul for every level of both
  images, one right matmul per level that also wrap-pads the width to
  whole 128-column blocks. Plain fp32 ``torch.matmul`` with TF32 off
  (``device.pin_fp32``), as the reference asks for HIGHEST precision;
- per level, ONE integer (p+3)^2 template patch (Scharr gradients and
  the bilinear blend are elementwise on it) and ONE cached search patch
  per feature, each cut by ``_gather_int_patches``: kernel K5
  (``ops/gather_cuda.py``) copies the [g, 256] bf16 window pair, then a
  ``torch.gather`` in f32 selects the g columns;
- the synchronized iteration ladder (<= ``iters`` steps, masked updates,
  all-converged early exit) samples the cached patch with two batched
  matmuls of fractional weights, in f32.

The image is rounded to bf16 exactly where the reference rounds it (the
window gather); everything after is f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import pyramid as pyr
from .gather_cuda import gather_window_pairs

_DRIFT = 6  # px per level beyond the initial guess


def pad_blocks(w: int) -> int:
    """128-aligned padded width covering any length-64 window starting
    in [0, w): enough whole blocks that block b+1 always exists."""
    return 128 * ((w - 1) // 128 + 2)


def _gather_int_patches(img_pad: torch.Tensor, v0: torch.Tensor, u0: torch.Tensor, g: int,
                        w: int) -> torch.Tensor:
    """[N] integer corners (u0 already wrapped into [0, w)) -> [N, g, g]
    f32 patches: patch[f, i, j] = bf16(img_pad)[clip(v0+i), u0+j]."""
    b = torch.div(u0, 128, rounding_mode="floor")
    win = gather_window_pairs(img_pad, v0, b, g)  # [N, g, 256] bf16 (stages 1-2)
    off = (u0 - b * 128).to(torch.int64)
    cols = off[:, None] + torch.arange(g, device=u0.device)
    return torch.gather(win.to(torch.float32), 2, cols[:, None, :].expand(-1, g, -1))


def _blend(patch: torch.Tensor, au: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """[N, g, g] integer patch -> [N, g-1, g-1] at fractional offset."""
    au, av = au[:, None, None], av[:, None, None]
    top = patch[:, :-1, :-1] * (1.0 - au) + patch[:, :-1, 1:] * au
    bot = patch[:, 1:, :-1] * (1.0 - au) + patch[:, 1:, 1:] * au
    return top * (1.0 - av) + bot * av


def _frac_weights(x: torch.Tensor, p: int, g: int) -> torch.Tensor:
    """[N] fractional positions -> [N, p, g] bilinear row weights
    max(0, 1 - |x + r - c|)."""
    r = torch.arange(p, dtype=x.dtype, device=x.device)[None, :, None]
    c = torch.arange(g, dtype=x.dtype, device=x.device)[None, None, :]
    return torch.clamp(1.0 - torch.abs(x[:, None, None] + r - c), min=0.0)


def _sample_in_patch(patch: torch.Tensor, lu: torch.Tensor, lv: torch.Tensor, p: int) -> torch.Tensor:
    """[N, p, p] windows at patch-local fractional origin (lu, lv) of
    [N, g, g] patches: two batched f32 matmuls."""
    g = patch.shape[1]
    rows = torch.bmm(_frac_weights(lv, p, g), patch)  # [N, p, g]
    return torch.bmm(rows, _frac_weights(lu, p, g).transpose(1, 2))  # [N, p, p]


def _track_level(img_i, img_j, w: int, uv_i, uv_j, valid, half_win: int, iters: int, eps: float,
                 min_eig_threshold: float, drift: int = _DRIFT):
    """One level for all features on [H, WP] wrap-padded images; ``w`` is
    the level's original width. Returns (uv, status, err)."""
    h = img_i.shape[0]
    p = 2 * half_win + 1
    npix = float(p * p)

    # template: ONE integer (p+3)^2 gather -> Scharr -> blend
    u_t, v_t = uv_i[:, 0], uv_i[:, 1]
    ok_in = valid & (v_t >= 0.0) & (v_t <= h - 1.0)
    v0f = torch.floor(v_t - half_win)
    u0f = torch.floor(u_t - half_win)
    au = u_t - half_win - u0f
    av = v_t - half_win - v0f
    ext = _gather_int_patches(img_i, v0f.to(torch.int32) - 1,
                              torch.remainder(u0f.to(torch.int32) - 1, w), p + 3, w)
    t_int = ext[:, 1:p + 2, 1:p + 2]
    sve = (3.0 * ext[:, :p + 1, :] + 10.0 * ext[:, 1:p + 2, :] + 3.0 * ext[:, 2:p + 3, :]) * (1.0 / 16.0)
    gx_int = 0.5 * (sve[:, :, 2:p + 3] - sve[:, :, :p + 1])
    she = (3.0 * ext[:, :, :p + 1] + 10.0 * ext[:, :, 1:p + 2] + 3.0 * ext[:, :, 2:p + 3]) * (1.0 / 16.0)
    gy_int = 0.5 * (she[:, 2:p + 3, :] - she[:, :p + 1, :])
    t_pat = _blend(t_int, au, av)
    gx_pat = _blend(gx_int, au, av)
    gy_pat = _blend(gy_int, au, av)

    gxx = (gx_pat * gx_pat).sum((1, 2))
    gxy = (gx_pat * gy_pat).sum((1, 2))
    gyy = (gy_pat * gy_pat).sum((1, 2))
    det = gxx * gyy - gxy * gxy
    min_eig = 0.5 * (gxx + gyy - torch.sqrt((gxx - gyy) ** 2 + 4.0 * gxy * gxy)) / npix
    ok_g = (min_eig > min_eig_threshold) & (det > 1e-12)
    inv_det = 1.0 / torch.where(ok_g, det, torch.ones_like(det))

    # moving image: ONE cached search patch per feature
    g = p + 2 * drift + 1
    cu = torch.floor(uv_j[:, 0] - half_win) - drift
    cv = torch.floor(uv_j[:, 1] - half_win) - drift
    jpatch = _gather_int_patches(img_j, cv.to(torch.int32), torch.remainder(cu.to(torch.int32), w), g, w)

    def in_patch(lu, lv):
        return (lu >= 0.0) & (lu <= g - p - 1.0) & (lv >= 0.0) & (lv <= g - p - 1.0)

    # synchronized ladder; updates are masked by `active`, so stopping once
    # every feature is frozen gives the same result as the full budget
    u, v = uv_j[:, 0], uv_j[:, 1]
    active = ok_in & ok_g
    for _ in range(iters):
        if not bool(active.any()):
            break
        lu, lv = u - half_win - cu, v - half_win - cv
        diff = _sample_in_patch(jpatch, lu, lv, p) - t_pat
        b0 = (diff * gx_pat).sum((1, 2))
        b1 = (diff * gy_pat).sum((1, 2))
        du = -(gyy * b0 - gxy * b1) * inv_det
        dv = -(-gxy * b0 + gxx * b1) * inv_det
        upd = active & in_patch(lu, lv)
        u = torch.where(upd, u + du, u)
        v = torch.where(upd, v + dv, v)
        active = upd & (du * du + dv * dv >= eps * eps)

    lu, lv = u - half_win - cu, v - half_win - cv
    ok_out = ok_in & ok_g & in_patch(lu, lv) & (v >= 0.0) & (v <= h - 1.0)
    u_out = torch.where(ok_out, u, u_t)
    v_out = torch.where(ok_out, v, v_t)
    # OpenCV-style err from the cached patches
    j_fin = _sample_in_patch(jpatch, torch.clamp(lu, 0.0, g - p - 1.0),
                             torch.clamp(lv, 0.0, g - p - 1.0), p)
    err = torch.abs(j_fin - t_pat).mean((1, 2))
    return torch.stack([u_out, v_out], -1), ok_out, err


def _pyr_device_build(h: int, w: int, num_levels: int):
    """Fused level operators: (shapes, bd, us, offs) with shapes[lvl] =
    (h_k, w_k); bd [sum 2h_k, 2H] applies every level's composed vertical
    blur to BOTH images stacked row-wise (None when num_levels == 0);
    us[lvl-1] [W, WP_k] is that level's (wrap-pad o blur)^T; offs[lvl-1]
    is the row offset of level lvl's 2h_k block in bd's output."""
    shapes = {}
    v_list, u_list = [], []
    v_k, u_k = np.eye(h), np.eye(w)
    h_k, w_k = h, w
    for lvl in range(num_levels + 1):
        shapes[lvl] = (h_k, w_k)
        if lvl > 0:
            u_pad = (pyr.wrap_pad_matrix(pad_blocks(w_k), w_k).astype(np.float64) @ u_k).T
            v_list.append(np.ascontiguousarray(v_k, np.float32))
            u_list.append(np.ascontiguousarray(u_pad, np.float32))
        if lvl < num_levels:
            v_k = pyr.blur_decimate_matrix(h_k, wrap=False).astype(np.float64) @ v_k
            u_k = pyr.blur_decimate_matrix(w_k, wrap=True).astype(np.float64) @ u_k
            h_k, w_k = -(-h_k // 2), -(-w_k // 2)
    if not v_list:
        return shapes, None, [], []
    bd = np.zeros((sum(2 * v.shape[0] for v in v_list), 2 * h), np.float32)
    offs, off = [], 0
    for v in v_list:
        hk = v.shape[0]
        bd[off:off + hk, :h] = v
        bd[off + hk:off + 2 * hk, h:] = v
        offs.append(off)
        off += 2 * hk
    return shapes, bd, u_list, offs


@functools.lru_cache(maxsize=8)
def _pyr_device(h: int, w: int, num_levels: int, device: str):
    """``_pyr_device_build``'s operators as tensors on ``device`` (cached)."""
    shapes, bd, us, offs = _pyr_device_build(h, w, num_levels)
    to = lambda a: torch.as_tensor(a, device=device)
    return shapes, None if bd is None else to(bd), [to(u) for u in us], offs


def _wrap_pad(img: torch.Tensor, wp: int) -> torch.Tensor:
    w = img.shape[1]
    reps = -(-wp // w)
    return torch.cat([img] * reps, 1)[:, :wp]


def level_images(img_prev, img_next, num_levels: int):
    """Both frames' pyramid levels, wrap-padded to whole 128-column
    blocks: [(im_i [h_k, WP_k], im_j, w_k) for levels 0..num_levels]."""
    h, w = img_prev.shape
    shapes, bd, us, offs = _pyr_device(h, w, num_levels, str(img_prev.device))
    img_prev = img_prev.to(torch.float32)
    img_next = img_next.to(torch.float32)
    out = [(_wrap_pad(img_prev, pad_blocks(w)), _wrap_pad(img_next, pad_blocks(w)), w)]
    if bd is not None:
        # every level of both images in one left matmul, one right matmul per level
        l_all = bd @ torch.cat([img_prev, img_next], 0)
        for lvl in range(1, num_levels + 1):
            hk = shapes[lvl][0]
            pair = l_all[offs[lvl - 1]:offs[lvl - 1] + 2 * hk] @ us[lvl - 1]
            out.append((pair[:hk], pair[hk:], shapes[lvl][1]))
    return out


def track(img_prev, img_next, uv_prev, valid_in, uv_guess=None, num_levels: int = 3,
          half_win: int = 10, iters: int = 8, eps: float = 0.01,
          min_eig_threshold: float = 1.5e-9):
    """Pyramidal LK, matmul-gather formulation. Returns (uv [N, 2] with
    u wrapped into [0, W), status [N], err [N])."""
    w = img_prev.shape[1]
    levels = level_images(img_prev, img_next, num_levels)
    uv = (uv_prev if uv_guess is None else uv_guess).to(torch.float32)
    uv_prev = uv_prev.to(torch.float32)
    status = valid_in
    err = torch.zeros(uv_prev.shape[0], device=uv_prev.device)
    # the topmost PROCESSED level absorbs the raw motion (full drift
    # margin); deeper levels refine an upsampled guess (3 px)
    heights = [im_i.shape[0] for im_i, _, _ in levels]
    top_lvl = max((lvl for lvl, hk in enumerate(heights) if hk >= half_win), default=0)
    for lvl in range(num_levels, -1, -1):
        if heights[lvl] < half_win:
            continue
        im_i, im_j, w_k = levels[lvl]
        s = 1.0 / (2.0 ** lvl)
        uv_l, status, err = _track_level(im_i, im_j, w_k, uv_prev * s, uv * s, status, half_win,
                                         iters, eps, min_eig_threshold,
                                         drift=_DRIFT if lvl == top_lvl else 3)
        uv = uv_l / s
    status = status & torch.isfinite(uv).all(-1)
    uv = torch.stack([torch.remainder(uv[:, 0], float(w)), uv[:, 1]], -1)
    return torch.where(status[:, None], uv, uv_prev), status, err
