"""Window BA and PnP as single launches: CUDA kernels K1-K3 + plain twins.

Counterpart of ``vio360_tpu/solver/ba_pallas.py``. Each wrapper takes
the JAX function's arguments and returns its results:

- ``pnp_solve``    (K1) <- ``ba_pallas.pnp_solve``    (``_pnp_solve_kernel``)
- ``ba_solve``     (K2) <- ``ba_pallas.ba_solve``     (``_ba_solve_kernel``)
- ``ba_iteration`` (K3) <- ``ba_pallas.ba_iteration`` (``_ba_iter_kernel``)

On a CUDA tensor a wrapper launches ``csrc/lm_solve.cu`` (or raises);
on a CPU tensor it runs the plain version beside it, a transliteration
of ``_lm_iteration`` / ``_lm_loop`` / ``_pnp_solve_kernel`` on [K, M]
planes with the same cephes atan polynomials. ``LAUNCHES`` counts
kernel launches only.

Launch shapes: K2 and K3 are one launch of ONE thread-block cluster of
16 CTAs x 512 threads (``ba_launch_info``); each CTA owns a contiguous
range of landmarks and the CTAs sum their partials over distributed
shared memory in rank order, so two calls on the same inputs return the
same bits and iteration count. K1 is one CTA of 512 threads that reads
f32 points and observations and bool masks in the caller's layout and
writes ``pnp_solve``'s outputs itself, so on the main path its wrapper
launches nothing else; given a leading batch dimension B it solves B
independent problems in one launch of B CTAs (``PNP_BATCHES`` counts
launches by B), each returning the bits of a launch of it alone. K2/K3 take a scratch buffer of M*K*18 (W blocks) + M*9 (V upper,
b_l) + M*9 (damped V^-1) + 3*M (trial landmarks) floats. A launch that
fails, a cluster that does not fit on the card included, raises.

The plain ``_lm_iteration`` is ``_damped_step(_linearize(...))``: the
first half depends on the state only, the second on the damping too,
which is what lets the kernels skip the linearization after a rejected
step (``tests/test_torch_lm_schedule.py``).
"""

from __future__ import annotations

import collections
import ctypes
import math
import weakref

import torch

from .. import cuda_build
from ..device import check_kernel_device

MAX_PIXEL_ERROR = 100.0
_TWO_PI = 2.0 * math.pi
_PI = math.pi
_MAX_K = 16

#: kernel launches by name ("lm_pnp", "lm_ba_solve", "lm_ba_iteration")
LAUNCHES: collections.Counter = collections.Counter()
#: K1 launches by batch size B (problems per launch)
PNP_BATCHES: collections.Counter = collections.Counter()


class _LmParams(ctypes.Structure):
    """Mirror of ``struct LmParams`` in csrc/lm_solve.cu."""

    _fields_ = [
        ("width", ctypes.c_float), ("height", ctypes.c_float),
        ("cu", ctypes.c_float), ("cv", ctypes.c_float),
        ("huber_delta", ctypes.c_float), ("inv_s2", ctypes.c_float),
        ("lam0", ctypes.c_float), ("step_tol", ctypes.c_float),
        ("rel_tol", ctypes.c_float), ("chi2_threshold", ctypes.c_float),
        ("rcb", ctypes.c_float * 9), ("tcb", ctypes.c_float * 3),
        ("diag_damping", ctypes.c_int), ("max_iterations", ctypes.c_int),
        ("rounds", ctypes.c_int),
    ]


_VP, _I, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_SIGS = {
    "lm_ba": [_VP] * 11 + [_I, _I, ctypes.POINTER(_LmParams), _I, _VP],
    "lm_ba_info": [_I, _IP, _IP, _IP],
    "lm_pnp": [_VP] * 11 + [_I, _I, ctypes.POINTER(_LmParams), _VP],
}

# id(tensor) -> (weak reference, version, its values): the extrinsic is the
# same tensor on every call of the main path, and reading it to the host
# would wait for the card each time.
_HOST_VALUES: dict[int, tuple] = {}


def _host_floats(t: torch.Tensor) -> list[float]:
    hit = _HOST_VALUES.get(id(t))
    if hit is not None and hit[0]() is t and hit[1] == t._version:
        return hit[2]
    vals = [float(x) for x in t.detach().reshape(-1).cpu().tolist()]
    _HOST_VALUES[id(t)] = (weakref.ref(t, lambda _, key=id(t): _HOST_VALUES.pop(key, None)), t._version, vals)
    return vals


def _params(width, height, pixel_noise_std, huber_delta, lam, r_cb, t_cb, *,
            step_tol, rel_tol=1e-6, chi2_threshold=0.0, diag_damping=False,
            max_iterations=0, rounds=0) -> _LmParams:
    rcb, tcb = _host_floats(r_cb), _host_floats(t_cb)
    return _LmParams(
        float(width), float(height), width / _TWO_PI, height / _PI,
        float(huber_delta), 1.0 / (pixel_noise_std * pixel_noise_std), float(lam),
        step_tol, rel_tol, chi2_threshold, (ctypes.c_float * 9)(*rcb),
        (ctypes.c_float * 3)(*tcb), int(diag_damping), int(max_iterations), int(rounds),
    )


def _lib():
    return cuda_build.load("lm_solve", _SIGS)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# Plain versions (twins of ba_pallas._evaluate_plane / _lm_iteration /
# _lm_loop / _pnp_solve_kernel on [K, M] tensors)
# ---------------------------------------------------------------------------


def _atan01(x):
    red = x > 0.4142135623730951
    xr = torch.where(red, (x - 1.0) / (x + 1.0), x)
    z = xr * xr
    y = (
        ((8.05374449538e-2 * z - 1.38776856032e-1) * z + 1.99777106478e-1) * z
        - 3.33329491539e-1
    ) * z * xr + xr
    return torch.where(red, math.pi / 4 + y, y)


def _atan2(a, b):
    abs_a, abs_b = torch.abs(a), torch.abs(b)
    q = torch.minimum(abs_a, abs_b) / torch.clamp(torch.maximum(abs_a, abs_b), min=1e-30)
    at = _atan01(q)
    at = torch.where(abs_a > abs_b, math.pi / 2 - at, at)
    at = torch.where(b < 0.0, math.pi - at, at)
    return torch.where(a < 0.0, -at, at)


def _evaluate_plane(r, t, px, py, pz, obs_u, obs_v, wmask, rcb, tcb, inv_s2, width, height, huber_delta):
    """ERP reprojection on [K, M] planes -> (pb, pc, du, dv, chi2, cost)."""
    d2 = huber_delta * huber_delta
    dx, dy, dz = px - t[0], py - t[1], pz - t[2]
    pb = [r[0][i] * dx + r[1][i] * dy + r[2][i] * dz for i in range(3)]
    pc = [rcb[i][0] * pb[0] + rcb[i][1] * pb[1] + rcb[i][2] * pb[2] + tcb[i] for i in range(3)]
    x, y, z = pc
    theta = _atan2(x, z)
    phi = -_atan2(y, torch.sqrt(torch.clamp(x * x + z * z, min=1e-24)))
    du = obs_u - width * (0.5 + theta / _TWO_PI)
    du = du - width * torch.round(du / width)
    dv = obs_v - height * (0.5 - phi / _PI)
    c2 = (du * du + dv * dv) * inv_s2
    rho = torch.where(c2 <= d2, c2, 2.0 * huber_delta * torch.sqrt(torch.clamp(c2, min=1e-20)) - d2)
    return pb, pc, du, dv, c2, 0.5 * (rho * wmask).sum()


def _pose_cols(pose12):
    r = [[pose12[:, 3 * i + j][:, None] for j in range(3)] for i in range(3)]
    t = [pose12[:, 9 + i][:, None] for i in range(3)]
    return r, t


def _linearize(pose12, px, py, pz, obs_u, obs_v, wmask, rcb, tcb, inv_s2, *, width, height,
               huber_delta):
    """The state-dependent half of ``_lm_iteration``: residuals, IRLS
    weights and Jacobians at (pose12, px, py, pz) -> (u_blk, b_p, v_blk,
    b_l, w_blk, cur_cost). Nothing here depends on lam."""
    d2 = huber_delta * huber_delta
    cu, cv = width / _TWO_PI, height / _PI
    r, t = _pose_cols(pose12)

    pb, pc, du, dv, c2, cur_cost = _evaluate_plane(r, t, px, py, pz, obs_u, obs_v, wmask, rcb, tcb,
                                                   inv_s2, width, height, huber_delta)
    w_huber = torch.where(c2 <= d2, torch.ones_like(c2), huber_delta / torch.sqrt(torch.clamp(c2, min=1e-20))) * inv_s2
    big = (torch.abs(du) > MAX_PIXEL_ERROR) | (torch.abs(dv) > MAX_PIXEL_ERROR)
    w = torch.where(big, torch.zeros_like(c2), w_huber * wmask)

    x, y, z = pc
    xz_sq = torch.clamp(x * x + z * z, min=1e-12)
    l_sq = torch.clamp(x * x + y * y + z * z, min=1e-12)
    xz = torch.sqrt(xz_sq)
    jpc = [
        [-(cu * z / xz_sq), torch.zeros_like(x), -(-cu * x / xz_sq)],
        [-(-cv * x * y / (l_sq * xz)), -(cv * xz / l_sq), -(-cv * y * z / (l_sq * xz))],
    ]
    jt = [[-(jpc[i][0] * rcb[0][j] + jpc[i][1] * rcb[1][j] + jpc[i][2] * rcb[2][j]) for j in range(3)] for i in range(2)]
    rh = [[-jt[i][j] for j in range(3)] for i in range(2)]
    jr = [
        [rh[i][1] * pb[2] + rh[i][2] * (-pb[1]), rh[i][0] * (-pb[2]) + rh[i][2] * pb[0],
         rh[i][0] * pb[1] + rh[i][1] * (-pb[0])]
        for i in range(2)
    ]
    jp = [jt[0] + jr[0], jt[1] + jr[1]]
    jl = [[rh[i][0] * r[j][0] + rh[i][1] * r[j][1] + rh[i][2] * r[j][2] for j in range(3)] for i in range(2)]
    res = [du, dv]

    u_blk = [[None] * 6 for _ in range(6)]
    for c in range(6):
        for f in range(c, 6):
            s = (w * (jp[0][c] * jp[0][f] + jp[1][c] * jp[1][f])).sum(1, keepdim=True)
            u_blk[c][f] = u_blk[f][c] = s
    b_p = [-(w * (jp[0][c] * res[0] + jp[1][c] * res[1])).sum(1, keepdim=True) for c in range(6)]
    v_blk = [[None] * 3 for _ in range(3)]
    for d in range(3):
        for e in range(d, 3):
            s = (w * (jl[0][d] * jl[0][e] + jl[1][d] * jl[1][e])).sum(0, keepdim=True)
            v_blk[d][e] = v_blk[e][d] = s
    b_l = [-(w * (jl[0][d] * res[0] + jl[1][d] * res[1])).sum(0, keepdim=True) for d in range(3)]
    w_blk = [[w * (jp[0][c] * jl[0][d] + jp[1][c] * jl[1][d]) for d in range(3)] for c in range(6)]
    return u_blk, b_p, v_blk, b_l, w_blk, cur_cost


def _damped_step(lin, pose12, px, py, pz, obs_u, obs_v, wmask, fixedpt, fm, lam, rcb, tcb, inv_s2,
                 *, k, width, height, huber_delta, diag_damping):
    """The lam-dependent half of ``_lm_iteration`` from a linearization
    ``lin`` of (pose12, px, py, pz): damped Schur system, unpivoted
    Gauss-Jordan, back-substitution, retraction and the trial cost ->
    (pose_new, px_new, py_new, pz_new, new_cost, step_sq)."""
    u_blk, b_p, v_blk, b_l, w_blk, _ = lin
    r, t = _pose_cols(pose12)
    if diag_damping:
        u_d = [[u_blk[c][f] * (1.0 + lam if c == f else 1.0) + (1e-10 if c == f else 0.0) for f in range(6)] for c in range(6)]
    else:
        u_tr = u_blk[0][0] + u_blk[1][1] + u_blk[2][2] + u_blk[3][3] + u_blk[4][4] + u_blk[5][5]
        u_d = [[u_blk[c][f] + (lam / 6.0) * u_tr * (1.0 if c == f else 0.0) for f in range(6)] for c in range(6)]
    v_tr = v_blk[0][0] + v_blk[1][1] + v_blk[2][2]
    a = [[v_blk[d][e] + ((lam / 3.0) * v_tr + 1e-8) * (1.0 if d == e else 0.0) for e in range(3)] for d in range(3)]
    co = [[None] * 3 for _ in range(3)]
    co[0][0] = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    co[0][1] = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    co[0][2] = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    co[1][0] = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    co[1][1] = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    co[1][2] = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    co[2][0] = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    co[2][1] = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    co[2][2] = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    det = a[0][0] * co[0][0] + a[0][1] * co[1][0] + a[0][2] * co[2][0]
    safe = torch.where(torch.abs(det) > 1e-30, det, torch.ones_like(det))
    inv_det = torch.where(fixedpt > 0.5, torch.zeros_like(det), 1.0 / safe)
    v_inv = [[co[d][e] * inv_det for e in range(3)] for d in range(3)]
    wv = [[w_blk[c][0] * v_inv[0][e] + w_blk[c][1] * v_inv[1][e] + w_blk[c][2] * v_inv[2][e] for e in range(3)] for c in range(6)]

    a_all = torch.cat([wv[ce // 3][ce % 3] for ce in range(18)], 0)  # [18K, M]
    b_all = torch.cat([w_blk[ce // 3][ce % 3] for ce in range(18)], 0)
    s_all = a_all @ b_all.T
    rhs_c = [b_p[c] - (wv[c][0] * b_l[0] + wv[c][1] * b_l[1] + wv[c][2] * b_l[2]).sum(1, keepdim=True) for c in range(6)]

    n6 = 6 * k
    diag_kk = torch.eye(k, dtype=pose12.dtype, device=pose12.device)
    rows = []
    for c in range(6):
        blocks = []
        for f in range(6):
            blk = -(
                s_all[3 * c * k:(3 * c + 1) * k, 3 * f * k:(3 * f + 1) * k]
                + s_all[(3 * c + 1) * k:(3 * c + 2) * k, (3 * f + 1) * k:(3 * f + 2) * k]
                + s_all[(3 * c + 2) * k:(3 * c + 3) * k, (3 * f + 2) * k:(3 * f + 3) * k]
            )
            blocks.append(blk + diag_kk * u_d[c][f])
        rows.append(torch.cat(blocks, 1))
    s_mat = torch.cat(rows, 0)
    rhs = torch.cat(rhs_c, 0)
    fm_col, fm_row = fm[:, None], fm[None, :]
    s_mat = s_mat * fm_col * fm_row + torch.eye(n6, dtype=s_mat.dtype, device=s_mat.device) * (1.0 - fm_col)
    rhs = rhs * fm_col

    aug = torch.cat([s_mat, rhs], 1)
    for i in range(n6):
        piv_row = aug[i:i + 1] / aug[i, i]
        keep = torch.ones(n6, 1, dtype=aug.dtype, device=aug.device)
        keep[i] = 0.0
        aug = aug - (keep * aug[:, i:i + 1]) * piv_row
        aug[i] = piv_row[0]
    x = aug[:, n6:n6 + 1]
    dx = [x[c * k:(c + 1) * k] for c in range(6)]

    tmp = [b_l[d] - sum(w_blk[c][d] * dx[c] for c in range(6)).sum(0, keepdim=True) for d in range(3)]
    dl = [(v_inv[d][0] * tmp[0] + v_inv[d][1] * tmp[1] + v_inv[d][2] * tmp[2]) * (1.0 - fixedpt) for d in range(3)]

    w0, w1, w2 = dx[3], dx[4], dx[5]
    th2 = w0 * w0 + w1 * w1 + w2 * w2
    th = torch.sqrt(torch.clamp(th2, min=1e-30))
    small = th2 < 1e-10
    sa = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    sb = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-30))
    sc = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / torch.clamp(th2 * th, min=1e-30))
    wv3 = [w0, w1, w2]
    hw = [[None, -w2, w1], [w2, None, -w0], [-w1, w0, None]]

    def rot_entry(ck, ck2, i, j):
        kij = hw[i][j] if hw[i][j] is not None else 0.0
        return (1.0 if i == j else 0.0) + ck * kij + ck2 * (wv3[i] * wv3[j] - (th2 if i == j else 0.0))

    dr = [[rot_entry(sa, sb, i, j) for j in range(3)] for i in range(3)]
    vm = [[rot_entry(sb, sc, i, j) for j in range(3)] for i in range(3)]
    dt = [vm[i][0] * dx[0] + vm[i][1] * dx[1] + vm[i][2] * dx[2] for i in range(3)]
    r_new = [[r[i][0] * dr[0][j] + r[i][1] * dr[1][j] + r[i][2] * dr[2][j] for j in range(3)] for i in range(3)]
    t_new = [r[i][0] * dt[0] + r[i][1] * dt[1] + r[i][2] * dt[2] + t[i] for i in range(3)]
    px_new, py_new, pz_new = px + dl[0], py + dl[1], pz + dl[2]
    *_, new_cost = _evaluate_plane(r_new, t_new, px_new, py_new, pz_new, obs_u, obs_v, wmask, rcb,
                                   tcb, inv_s2, width, height, huber_delta)
    step_sq = (x * x).sum() + (dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2]).sum()
    pose_new = torch.cat([r_new[i][j] for i in range(3) for j in range(3)] + t_new, 1)
    return pose_new, px_new, py_new, pz_new, new_cost, step_sq


def _lm_iteration(pose12, px, py, pz, obs_u, obs_v, wmask, fixedpt, fm, lam, rcb, tcb,
                  inv_s2, *, k, width, height, huber_delta, diag_damping):
    """Twin of ba_pallas._lm_iteration. pose12 [K, 12]; px/py/pz/fixedpt
    [1, M]; planes [K, M]; fm [6K] free-pose mask in (c, k) order; rcb /
    tcb as nested lists of 0-d tensors. Returns (pose_new, px_new,
    py_new, pz_new, cur_cost, new_cost, step_sq)."""
    lin = _linearize(pose12, px, py, pz, obs_u, obs_v, wmask, rcb, tcb, inv_s2, width=width,
                     height=height, huber_delta=huber_delta)
    pose_new, px_new, py_new, pz_new, new_cost, step_sq = _damped_step(
        lin, pose12, px, py, pz, obs_u, obs_v, wmask, fixedpt, fm, lam, rcb, tcb, inv_s2, k=k,
        width=width, height=height, huber_delta=huber_delta, diag_damping=diag_damping)
    return pose_new, px_new, py_new, pz_new, lin[-1], new_cost, step_sq


def _lm_loop(pose0, px0, py0, pz0, obs_u, obs_v, wmask, fixedpt, fm, lam0, rcb, tcb, inv_s2, *,
             k, width, height, huber_delta, diag_damping, max_iterations, step_tol, rel_tol):
    """Twin of ba_pallas._lm_loop (host loop; CPU only)."""
    pose, px, py, pz = pose0, px0, py0, pz0
    lam = float(lam0)
    cost = torch.zeros((), dtype=pose0.dtype, device=pose0.device)
    it, done = 0, False
    while it < max_iterations and not done:
        pose_n, pxn, pyn, pzn, cur, new, step = _lm_iteration(
            pose, px, py, pz, obs_u, obs_v, wmask, fixedpt, fm,
            torch.tensor(lam, dtype=pose0.dtype, device=pose0.device), rcb, tcb, inv_s2,
            k=k, width=width, height=height, huber_delta=huber_delta, diag_damping=diag_damping,
        )
        accept = bool(new < cur)
        if accept:
            pose, px, py, pz = pose_n, pxn, pyn, pzn
        lam = float(torch.tensor(max(lam * 0.5, 1e-9) if accept else min(lam * 4.0, 1e6), dtype=torch.float32))
        done = (accept and (bool(step < step_tol) or bool((cur - new) < rel_tol * cur))) or lam > 1e5
        cost = new if accept else cur
        it += 1
    return pose, px, py, pz, cost, it


def _scalars(r_cb, t_cb):
    rcb = [[r_cb[i, j] for j in range(3)] for i in range(3)]
    tcb = [t_cb[i] for i in range(3)]
    return rcb, tcb


def _plain_inputs(r_wb, t_wb, points, fixed_pose, k):
    pose = torch.cat([r_wb.reshape(k, 9), t_wb.reshape(k, 3)], 1).float()
    pts = points.float()
    fm = (~fixed_pose).float().repeat(6)  # (c, k) order
    return pose, pts[:, 0][None], pts[:, 1][None], pts[:, 2][None], fm


def _unpack_pose(pose, k):
    return pose[:, :9].reshape(k, 3, 3), pose[:, 9:]


def _ba_plain(r_wb, t_wb, points, obs_uv, obs_w, fixed_pose, fixed_point, lam, r_cb, t_cb,
              width, height, pixel_noise_std, huber_delta, diag_damping, max_iterations):
    k = obs_w.shape[0]
    pose, px, py, pz, fm = _plain_inputs(r_wb, t_wb, points, fixed_pose, k)
    rcb, tcb = _scalars(r_cb.float(), t_cb.float())
    kw = dict(k=k, width=float(width), height=float(height), huber_delta=float(huber_delta),
              diag_damping=diag_damping)
    args = (obs_uv[..., 0].float(), obs_uv[..., 1].float(), obs_w.float(), fixed_point.float()[None], fm)
    inv_s2 = 1.0 / (pixel_noise_std * pixel_noise_std)
    if max_iterations is None:
        out = _lm_iteration(pose, px, py, pz, *args,
                            torch.as_tensor(lam, dtype=torch.float32, device=pose.device),
                            rcb, tcb, inv_s2, **kw)
        pose_n, pxn, pyn, pzn, cur, new, step = out
        r, t = _unpack_pose(pose_n, k)
        return r, t, torch.cat([pxn, pyn, pzn], 0).T, cur, new, step
    pose_n, pxn, pyn, pzn, cost, it = _lm_loop(
        pose, px, py, pz, *args, lam, rcb, tcb, inv_s2, **kw,
        max_iterations=max_iterations, step_tol=1e-14, rel_tol=1e-6,
    )
    r, t = _unpack_pose(pose_n, k)
    return r, t, torch.cat([pxn, pyn, pzn], 0).T, cost, torch.tensor(it, dtype=torch.int32, device=pose.device)


def _pnp_plain(r_wb, t_wb, points, obs_uv, active, marginalized, lam, r_cb, t_cb, width, height,
               pixel_noise_std, huber_delta, chi2_threshold, rounds, max_iterations):
    """Twin of ba_pallas._pnp_solve_kernel; a leading batch dimension is
    solved one problem after the other."""
    if points.dim() == 3:
        outs = [_pnp_plain(r_wb[b], t_wb[b], points[b], obs_uv[b], active[b], marginalized[b], lam,
                           r_cb, t_cb, width, height, pixel_noise_std, huber_delta, chi2_threshold,
                           rounds, max_iterations) for b in range(points.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    m = points.shape[0]
    pose0 = torch.cat([r_wb.reshape(1, 9), t_wb.reshape(1, 3)], 1).float()
    pts = points.float()
    px, py, pz = pts[:, 0][None], pts[:, 1][None], pts[:, 2][None]
    obs_u, obs_v = obs_uv[:, 0].float()[None], obs_uv[:, 1].float()[None]
    act = active.float()[None]
    marg = marginalized.float()[None]
    dev = points.device
    fixedpt = torch.ones(1, m, device=dev)
    fm = torch.ones(6, device=dev)
    rcb, tcb = _scalars(r_cb.float(), t_cb.float())
    inv_s2 = 1.0 / (pixel_noise_std * pixel_noise_std)
    pose_fin = pose0
    outlier = torch.zeros(1, m, device=dev)
    final_cost = torch.zeros((), device=dev)
    for _ in range(rounds):
        wmask = act * (1.0 - outlier)
        pose_fin, *_ = _lm_loop(
            pose0, px, py, pz, obs_u, obs_v, wmask, fixedpt, fm, lam, rcb, tcb, inv_s2,
            k=1, width=float(width), height=float(height), huber_delta=float(huber_delta),
            diag_damping=True, max_iterations=max_iterations, step_tol=1e-16, rel_tol=1e-6,
        )
        r_s, t_s = _pose_cols(pose_fin)
        *_, c2, _ = _evaluate_plane(r_s, t_s, px, py, pz, obs_u, obs_v, act, rcb, tcb, inv_s2,
                                    float(width), float(height), float(huber_delta))
        outlier = act * (1.0 - marg) * (c2 > chi2_threshold).float()
        inl = act * (1.0 - outlier)
        final_cost = (inl * c2).sum() / torch.clamp(inl.sum(), min=1.0)
    inl = act * (1.0 - outlier)
    return (pose_fin[0, :9].reshape(3, 3), pose_fin[0, 9:], outlier[0] > 0.5, final_cost,
            inl.sum().to(torch.int32), outlier.sum().to(torch.int32))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name, tensors: dict, device):
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")


def _ba_launch(r_wb, t_wb, points, obs_uv, obs_w, fixed_pose, fixed_point, lam, r_cb, t_cb,
               width, height, pixel_noise_std, huber_delta, diag_damping, max_iterations):
    """K2 (max_iterations an int) or K3 (None) as one cluster launch."""
    k, m = obs_w.shape
    dev = obs_w.device
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"lm_ba: K={k} outside [1, {_MAX_K}]")
    if obs_uv.shape != (k, m, 2) or points.shape != (m, 3) or r_wb.shape != (k, 3, 3):
        raise ValueError("lm_ba: inconsistent shapes")
    _check("lm_ba", dict(r_wb=r_wb, t_wb=t_wb, points=points, obs_uv=obs_uv,
                         fixed_pose=fixed_pose, fixed_point=fixed_point), dev)
    pose = _f32(torch.cat([r_wb.reshape(k, 9), t_wb.reshape(k, 3)], 1))
    pts = _f32(points.T)
    obs_u, obs_v = _f32(obs_uv[..., 0]), _f32(obs_uv[..., 1])
    wmask = _f32(obs_w)
    fixedpt = _f32(fixed_point)
    fm = _f32(~fixed_pose)
    pose_out = torch.empty_like(pose)
    pts_out = torch.empty_like(pts)
    scal = torch.empty(4, dtype=torch.float32, device=dev)
    scratch = torch.empty(m * k * 18 + m * 9 + m * 9 + 3 * m, dtype=torch.float32, device=dev)
    single = max_iterations is None
    prm = _params(width, height, pixel_noise_std, huber_delta, lam, r_cb, t_cb, step_tol=1e-14,
                  diag_damping=diag_damping, max_iterations=max_iterations or 0)
    ptr = cuda_build.ptr
    err = _lib().lm_ba(
        ptr(pose), ptr(pts), ptr(obs_u), ptr(obs_v), ptr(wmask), ptr(fixedpt), ptr(fm),
        ptr(pose_out), ptr(pts_out), ptr(scal), ptr(scratch), k, m, ctypes.byref(prm),
        int(single), cuda_build.stream_ptr(dev),
    )
    cuda_build.check(err, "lm_ba launch")
    LAUNCHES["lm_ba_iteration" if single else "lm_ba_solve"] += 1
    r, t = _unpack_pose(pose_out, k)
    if single:
        return r, t, pts_out.T, scal[0], scal[1], scal[2]
    return r, t, pts_out.T, scal[0], scal[1].to(torch.int32)


def ba_launch_info(k: int) -> dict:
    """K2/K3's launch shape at K poses: CTAs per cluster, dynamic shared
    memory per CTA and how many such clusters fit on the card at once
    (needs the card)."""
    ctas, smem, fit = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.check(_lib().lm_ba_info(k, ctypes.byref(ctas), ctypes.byref(smem), ctypes.byref(fit)),
                     "lm_ba_info")
    return {"cluster_ctas": ctas.value, "threads_per_cta": 512, "smem_bytes_per_cta": smem.value,
            "max_active_clusters": fit.value}


def ba_iteration(r_wb, t_wb, points, obs_uv, obs_w, fixed_pose, fixed_point, lam, r_cb, t_cb,
                 width, height, pixel_noise_std=1.0, huber_delta=1.0, diag_damping=False):
    """K3: one LM iteration (no accept/reject). Returns (r_new, t_new,
    pts_new, cur_cost, new_cost, step_sq)."""
    args = (r_wb, t_wb, points, obs_uv, obs_w, fixed_pose, fixed_point, lam, r_cb, t_cb,
            width, height, pixel_noise_std, huber_delta, diag_damping, None)
    if check_kernel_device(obs_w, "ba_iteration"):
        return _ba_launch(*args)
    return _ba_plain(*args)


def ba_solve(r_wb, t_wb, points, obs_uv, obs_w, fixed_pose, fixed_point, lam, r_cb, t_cb,
             width, height, pixel_noise_std=1.0, huber_delta=1.0, diag_damping=False,
             max_iterations=50):
    """K2: the whole LM solve. Returns (r_new, t_new, pts_new, final_cost, iters)."""
    args = (r_wb, t_wb, points, obs_uv, obs_w, fixed_pose, fixed_point, lam, r_cb, t_cb,
            width, height, pixel_noise_std, huber_delta, diag_damping, int(max_iterations))
    if check_kernel_device(obs_w, "ba_solve"):
        return _ba_launch(*args)
    return _ba_plain(*args)


def pnp_solve(r_wb, t_wb, points, obs_uv, active, marginalized, lam, r_cb, t_cb, width, height,
              pixel_noise_std=1.0, huber_delta=1.0, chi2_threshold=5.991, rounds=4,
              max_iterations=50):
    """K1: the whole PnP (rounds x LM + chi2 classification). Returns
    (r_new, t_new, outlier [M] bool, final_cost, n_inl, n_out); with a
    leading batch dimension B on every per-problem argument (r [B,3,3],
    t [B,3], points [B,M,3], obs [B,M,2], masks [B,M]) each result gains
    it too, and the B problems are one launch."""
    args = (r_wb, t_wb, points, obs_uv, active, marginalized, float(lam), r_cb, t_cb, width, height,
            pixel_noise_std, huber_delta, chi2_threshold, rounds, max_iterations)
    if not check_kernel_device(points, "pnp_solve"):
        return _pnp_plain(*args)
    return _pnp_launch(*args)[:6]


def _pnp_launch(r_wb, t_wb, points, obs_uv, active, marginalized, lam, r_cb, t_cb, width, height,
                pixel_noise_std, huber_delta, chi2_threshold, rounds, max_iterations):
    """K1's launch -> pnp_solve's results and the LM iterations over all
    rounds (per problem when batched)."""
    lead = points.shape[:-2]  # () or (B,)
    if len(lead) > 1:
        raise ValueError("lm_pnp: at most one batch dimension")
    b, m = (lead[0] if lead else 1), points.shape[-2]
    dev = points.device
    if (points.shape != (*lead, m, 3) or r_wb.shape != (*lead, 3, 3) or t_wb.shape != (*lead, 3)
            or obs_uv.shape != (*lead, m, 2) or active.shape != (*lead, m)
            or marginalized.shape != (*lead, m)):
        raise ValueError("lm_pnp: inconsistent shapes")
    _check("lm_pnp", dict(r_wb=r_wb, t_wb=t_wb, obs_uv=obs_uv, active=active, marginalized=marginalized), dev)
    r_in, t_in, pts, obs = _f32(r_wb), _f32(t_wb), _f32(points), _f32(obs_uv)
    act, marg = (x.to(torch.bool).contiguous().view(torch.uint8) for x in (active, marginalized))
    r_out = torch.empty(*lead, 3, 3, dtype=torch.float32, device=dev)
    t_out = torch.empty(*lead, 3, dtype=torch.float32, device=dev)
    outlier = torch.empty(*lead, m, dtype=torch.bool, device=dev)
    cost = torch.empty(lead, dtype=torch.float32, device=dev)
    counts = torch.empty(*lead, 3, dtype=torch.int32, device=dev)  # inliers, outliers, LM iterations
    prm = _params(width, height, pixel_noise_std, huber_delta, lam, r_cb, t_cb, step_tol=1e-16,
                  chi2_threshold=chi2_threshold, diag_damping=True,
                  max_iterations=max_iterations, rounds=rounds)
    ptr = cuda_build.ptr
    err = _lib().lm_pnp(
        ptr(r_in), ptr(t_in), ptr(pts), ptr(obs), ptr(act), ptr(marg), ptr(r_out), ptr(t_out),
        ptr(outlier), ptr(cost), ptr(counts), m, b, ctypes.byref(prm), cuda_build.stream_ptr(dev),
    )
    cuda_build.check(err, "lm_pnp launch")
    LAUNCHES["lm_pnp"] += 1
    PNP_BATCHES[b] += 1
    return r_out, t_out, outlier, cost, counts[..., 0], counts[..., 1], counts[..., 2]
