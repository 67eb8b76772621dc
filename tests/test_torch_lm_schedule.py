"""The premise of the LM kernels' schedule, on the CPU, from the plain pieces.

K1 and K2 (``csrc/lm_solve.cu``) linearize only after an accepted step:
after a rejected one only the damping changes, and the reference
(``ba_pallas._lm_loop``, twinned by ``ba_cuda._lm_loop``) re-linearizes
at an unchanged state. These tests hold that premise on the plain
versions: the current cost does not depend on lambda, and a loop that
reuses the linearization across rejected steps (``_linearize`` once per
accepted state, ``_damped_step`` per iteration) walks the same
(lambda, cost, new cost) sequence, bit for bit, to the same cost and
iteration count as ``_lm_loop`` on a K = 1 (PnP) and a K = 10 (window
BA) problem. Seconds on the CPU; no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vio360_tpu_torch.geometry import camera as tcam, lie as tlie
from vio360_tpu_torch.solver import ba_cuda

W, H = 960, 480


def _f(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _problem(k: int):
    """Plain-version inputs and keywords of a K = 1 PnP (every landmark
    fixed, diagonal damping, outliers) or a K = 10 window BA problem."""
    rng = np.random.default_rng(40 + k)
    m = 256
    pts = _f(rng.uniform(-5, 5, (m, 3)) + np.array([0, 0, 7.0]))
    rcb, tcb = tlie.so3_exp(_f([0.02, -0.01, 0.03])), _f([0.01, 0.0, -0.02])
    if k == 1:
        rs, ts = tlie.so3_exp(_f([[0.03, -0.02, 0.01]])), _f([[0.15, -0.1, 0.2]])
    else:
        rs = tlie.so3_exp(_f(rng.uniform(-0.05, 0.05, (k, 3))))
        ts = _f(np.cumsum(rng.uniform(-0.05, 0.08, (k, 3)), 0))
    p_b = torch.einsum("kji,mj->kmi", rs, pts) - torch.einsum("kji,kj->ki", rs, ts)[:, None]
    uv = tcam.project(torch.einsum("ij,kmj->kmi", rcb, p_b) + tcb, W, H)
    uv = uv + _f(rng.standard_normal((k, m, 2)) * 0.5)
    uv[:, : m // 16] += 40.0  # outliers: Huber weights and the 100-px cut at work
    if k == 1:
        # a start far enough off that some steps are rejected
        r0, t0 = tlie.so3_exp(_f([[0.3, -0.2, 0.1]])), _f([[1.0, -0.5, 0.5]])
        wmask = _f(rng.random((1, m)) < 0.9)
        fixedpt = torch.ones(1, m)
        fm = torch.ones(6)
    else:
        r0 = rs
        t0 = ts + _f(rng.normal(0, 0.03, (k, 3)))
        t0[0] = ts[0]
        pts = pts + _f(rng.normal(0, 0.05, (m, 3)))
        wmask = _f(rng.random((k, m)) < 0.7)
        fixedpt = _f(rng.random((1, m)) < 0.1)
        fixed_pose = torch.zeros(k, dtype=torch.bool)
        fixed_pose[0] = True
        fm = (~fixed_pose).float().repeat(6)
    pose = torch.cat([r0.reshape(k, 9), t0.reshape(k, 3)], 1)
    rcb_s, tcb_s = ba_cuda._scalars(rcb, tcb)
    state = (pose, pts[:, 0][None], pts[:, 1][None], pts[:, 2][None])
    planes = (uv[..., 0], uv[..., 1], wmask)
    kw = dict(k=k, width=float(W), height=float(H), huber_delta=1.0, diag_damping=k == 1)
    return state, planes, fixedpt, fm, rcb_s, tcb_s, kw


@pytest.mark.parametrize("k", [1, 10])
def test_cur_cost_does_not_depend_on_lambda(k):
    state, planes, fixedpt, fm, rcb, tcb, kw = _problem(k)
    costs = [ba_cuda._lm_iteration(*state, *planes, fixedpt, fm, torch.tensor(lam), rcb, tcb, 1.0,
                                   **kw)[4]
             for lam in (1e-4, 4e-4)]
    assert torch.equal(costs[0], costs[1])


def _reuse_loop(state, planes, fixedpt, fm, lam0, rcb, tcb, *, max_iterations, step_tol, rel_tol,
                **kw):
    """``_lm_loop``'s control flow, linearizing once per accepted state
    (the kernels' schedule) -> ([(lam, cur, new)], cost, iterations)."""
    lin_kw = dict(width=kw["width"], height=kw["height"], huber_delta=kw["huber_delta"])
    lin = ba_cuda._linearize(*state, *planes, rcb, tcb, 1.0, **lin_kw)
    lam, it, done, cost, seq = float(lam0), 0, False, None, []
    while it < max_iterations and not done:
        lam_t = torch.tensor(lam)
        trial = ba_cuda._damped_step(lin, *state, *planes, fixedpt, fm, lam_t, rcb, tcb, 1.0, **kw)
        cur, new, step = lin[-1], trial[4], trial[5]
        seq.append((float(lam_t), cur, new))
        accept = bool(new < cur)
        if accept:
            state = trial[:4]
            lin = ba_cuda._linearize(*state, *planes, rcb, tcb, 1.0, **lin_kw)
        lam = float(torch.tensor(max(lam * 0.5, 1e-9) if accept else min(lam * 4.0, 1e6),
                                 dtype=torch.float32))
        done = (accept and (bool(step < step_tol) or bool((cur - new) < rel_tol * cur))) or lam > 1e5
        cost = new if accept else cur
        it += 1
    return seq, cost, it


@pytest.mark.parametrize("k", [1, 10])
def test_reuse_on_reject_walks_lm_loop(k, monkeypatch):
    state, planes, fixedpt, fm, rcb, tcb, kw = _problem(k)
    loop_kw = dict(max_iterations=25, step_tol=1e-16 if k == 1 else 1e-14, rel_tol=1e-6)
    seq = []
    plain_iteration = ba_cuda._lm_iteration

    def recording(*args, **kwargs):
        out = plain_iteration(*args, **kwargs)
        seq.append((float(args[9]), out[4], out[5]))
        return out

    monkeypatch.setattr(ba_cuda, "_lm_iteration", recording)
    *_, cost, it = ba_cuda._lm_loop(*state, *planes, fixedpt, fm, 1e-4, rcb, tcb, 1.0, **kw, **loop_kw)
    monkeypatch.undo()
    got, got_cost, got_it = _reuse_loop(state, planes, fixedpt, fm, 1e-4, rcb, tcb, **kw, **loop_kw)
    assert any(not bool(new < cur) for _, cur, new in seq), "no rejected step: the premise is untested"
    assert got_it == it == len(seq) == len(got)
    for (lam_r, cur_r, new_r), (lam_g, cur_g, new_g) in zip(seq, got):
        assert lam_r == lam_g
        assert torch.equal(cur_r, cur_g) and torch.equal(new_r, new_g)
    assert torch.equal(cost, got_cost)
