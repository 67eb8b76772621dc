"""The port's pose graph and marginals against the JAX package.

- Edge residuals and their exact right-perturbation Jacobians, SE(3) and
  Sim(3), on a perturbed circle graph: 1e-4.
- ``optimize_pose_graph`` / ``optimize_pose_graph_sim3`` on that graph
  (two fixed poses, an invalid edge, a loop edge): poses within 1e-4, the
  bound of tests/test_pose_graph.py::test_sharded_equals_unsharded.
- ``window_relpose_sqrt_info`` on the toy window of tests/test_marginals.py:
  2e-3 relative (that file's bound); ``preint_edge_sqrt_info_diag``: 1e-6.
- Estimator level: a short port run at tests/test_e2e_pose_graph.py's
  configuration (4-keyframe window), with keyframes at 5 px of parallax
  instead of 9 so that two evictions happen within 24 frames. Each eviction's edge weights equal
  JAX's ``window_pair_sqrt_info`` on the converted pre-eviction window
  (2e-3 relative), and the export's SE(3) solve, and its Sim(3) solve
  after a loop edge is added, equal the JAX estimator's export solve fed
  the port's nodes, edges, pose log and window (1e-4).
(The pending-IMU keyframe path's eviction capture is in
tests/test_torch_pending_imu.py.)
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from vio360_tpu.estimator import estimator as jest_mod, window as jwin
    from vio360_tpu.estimator.estimator import Estimator as JaxEstimator
    from vio360_tpu.solver import marginals as jmarg, pose_graph as jpg
    from test_torch_port import port_cfg
    from vio360_tpu import config as cfgmod
except ModuleNotFoundError as e:
    # A card's machine may have no JAX: there only ``pytest -m cuda`` is meaningful.
    if e.name != "jax":
        raise
from vio360_tpu_torch import convert, synthetic as tsyn
from vio360_tpu_torch.estimator import estimator as port_est, fused as tfused
from vio360_tpu_torch.geometry import lie as tlie
from vio360_tpu_torch.solver import marginals as tmarg, pose_graph as tpg

torch.set_num_threads(1)

W, H = 480, 240


def _t(x):
    return torch.as_tensor(np.array(x))


def _circle_graph(p=12, seed=1):
    """Circle poses, exact stride-1/2 relative edges, a loop edge 0 -> p-1
    measured with an offset, an invalid edge, and the poses perturbed."""
    ang = np.linspace(0.0, 1.5 * np.pi, p)
    ts = np.stack([2.0 * np.cos(ang), 2.0 * np.sin(ang), 0.1 * ang], -1).astype(np.float32)
    rs = tlie.so3_exp(_t(np.stack([np.zeros(p), np.zeros(p), ang], -1).astype(np.float32))).numpy()
    ei, ej = [], []
    for s in (1, 2):
        ei += list(range(p - s))
        ej += list(range(s, p))
    ei += [0, 3]
    ej += [p - 1, 5]
    ei, ej = np.asarray(ei), np.asarray(ej)
    rel_r, rel_t = tlie.se3_compose(*tlie.se3_inverse(_t(rs[ei]), _t(ts[ei])), _t(rs[ej]), _t(ts[ej]))
    rel_t = rel_t.numpy()
    rel_t[-2] += 0.05  # the loop edge disagrees a little with the odometry
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.standard_normal((p, 3)) * 0.05, rng.standard_normal((p, 3)) * 0.02], 1)
    xi[0] = 0.0
    dr, dt = tlie.se3_exp(_t(xi.astype(np.float32)))
    rs2, ts2 = tlie.se3_compose(_t(rs), _t(ts), dr, dt)
    c = len(ei)
    w = np.ones((c, 6), np.float32)
    w[-2] = 3.0
    valid = np.ones(c, bool)
    valid[-1] = False
    fixed = np.zeros(p, bool)
    fixed[[0, 6]] = True
    return (rs2.numpy(), ts2.numpy(), ei.astype(np.int32), ej.astype(np.int32), rel_r.numpy(),
            rel_t, w, valid, fixed)


@pytest.mark.parametrize("kind", ["se3", "sim3"])
def test_edge_jacobians_match_jax(kind):
    import jax

    rs, ts, ei, ej, rel_r, rel_t, *_ = _circle_graph()
    ls = np.random.default_rng(3).normal(0, 0.1, len(rs)).astype(np.float32)
    if kind == "se3":
        jres, jji, jjj = jax.jit(jax.vmap(jpg._edge_residual_jac))(
            jnp.asarray(rs[ei]), jnp.asarray(ts[ei]), jnp.asarray(rs[ej]), jnp.asarray(ts[ej]),
            jnp.asarray(rel_r), jnp.asarray(rel_t))
        tres, tji, tjj = tpg.edge_residual_jac(_t(rs[ei]), _t(ts[ei]), _t(rs[ej]), _t(ts[ej]),
                                               _t(rel_r), _t(rel_t))
    else:
        jres, jji, jjj = jax.jit(jax.vmap(jpg._sim3_residual_jac))(
            jnp.asarray(rs[ei]), jnp.asarray(ts[ei]), jnp.asarray(ls[ei]), jnp.asarray(rs[ej]),
            jnp.asarray(ts[ej]), jnp.asarray(ls[ej]), jnp.asarray(rel_r), jnp.asarray(rel_t))
        tres, tji, tjj = tpg.sim3_residual_jac(_t(rs[ei]), _t(ts[ei]), _t(ls[ei]), _t(rs[ej]),
                                               _t(ts[ej]), _t(ls[ej]), _t(rel_r), _t(rel_t))
    for a, b in ((jres, tres), (jji, tji), (jjj, tjj)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


@pytest.mark.parametrize("kind", ["se3", "sim3"])
def test_pose_graph_matches_jax(kind):
    rs, ts, ei, ej, rel_r, rel_t, w, valid, fixed = _circle_graph()
    if kind == "sim3":
        w = np.concatenate([w, np.full((len(w), 1), 20.0, np.float32)], 1)
    args = (rs, ts, ei, ej, rel_r, rel_t, w, valid, fixed)
    jfn, tfn = ((jpg.optimize_pose_graph, tpg.optimize_pose_graph) if kind == "se3"
                else (jpg.optimize_pose_graph_sim3, tpg.optimize_pose_graph_sim3))
    jr = jfn(*(jnp.asarray(a) for a in args))
    tr = tfn(*(_t(a) for a in args))
    assert float(tr.final_cost) < 0.1 * float(tr.initial_cost)
    np.testing.assert_allclose(tr.t_wb.numpy(), np.asarray(jr.t_wb), atol=1e-4)
    np.testing.assert_allclose(tr.r_wb.numpy(), np.asarray(jr.r_wb), atol=1e-4)
    np.testing.assert_array_equal(tr.t_wb.numpy()[fixed], ts[fixed])
    if kind == "sim3":
        np.testing.assert_allclose(tr.log_s.numpy(), np.asarray(jr.log_s), atol=1e-4)


def test_marginals_match_jax():
    rng = np.random.default_rng(0)
    k, m = 4, 48
    pts = (rng.uniform(-4, 4, (m, 3)) + np.array([0, 0, 6.0])).astype(np.float32)
    rs = tlie.so3_exp(_t(rng.normal(0, 0.03, (k, 3)).astype(np.float32))).numpy()
    ts = np.cumsum(rng.uniform(-0.05, 0.08, (k, 3)), 0).astype(np.float32)
    p_c = np.einsum("kji,kmj->kmi", rs, pts[None] - ts[:, None])
    from vio360_tpu_torch.geometry import camera as tcam

    uv = (tcam.project(_t(p_c.astype(np.float32)), W, H).numpy()
          + rng.standard_normal((k, m, 2)).astype(np.float32) * 0.3)
    mask = rng.random((k, m)) >= 0.2
    fixed_pose = np.arange(k) == 0
    fixed_point = rng.random(m) < 0.1
    r_cb = tlie.so3_exp(_t(np.float32([0.01, -0.02, 0.01]))).numpy()
    t_cb = np.float32([0.02, 0.0, -0.01])
    pair_i, pair_j = np.int32([0, 0, 1]), np.int32([1, 2, 3])
    args = (rs, ts, pts, uv, mask, fixed_pose, fixed_point, r_cb, t_cb, pair_i, pair_j)
    jw = np.asarray(jmarg.window_relpose_sqrt_info(*(jnp.asarray(a) for a in args), W, H))
    tw = tmarg.window_relpose_sqrt_info(*(_t(a) for a in args), W, H).numpy()
    np.testing.assert_allclose(tw, jw, rtol=2e-3)
    cov_r, cov_p = rng.uniform(1e-7, 1e-4, 3), rng.uniform(1e-6, 1e-3, 3)
    for dt in (0.05, 0.5):
        for a, b in zip(tmarg.preint_edge_sqrt_info_diag(cov_r, cov_p, dt),
                        jmarg.preint_edge_sqrt_info_diag(cov_r, cov_p, dt)):
            np.testing.assert_allclose(a, b, rtol=1e-6)


# ---------------------------------------------------------------------------
# Estimator level
# ---------------------------------------------------------------------------


def _jax_cfg():
    return cfgmod.VioConfig(
        camera=cfgmod.CameraConfig(width=W, height=H, boundary_margin=10.0),
        features=cfgmod.FeatureConfig(max_features=250, capacity=256, min_distance=10.0,
                                      quality_level=0.02, grid_cols=10, grid_rows=5,
                                      max_features_per_grid=10),
        ransac=cfgmod.RansacConfig(max_iterations=300),
        init=cfgmod.InitializationConfig(window_size=8, min_features=50, min_observations=8,
                                         min_parallax=8.0),
        tracking=cfgmod.TrackingConfig(min_parallax_for_keyframe=5.0),
        window=cfgmod.WindowConfig(max_keyframes=4, max_landmarks=512),
        loop=cfgmod.LoopConfig(enabled=False),
    )


def _jax_window(win):
    return jwin.WindowState(**{k: jnp.asarray(v) for k, v in convert.to_numpy(win).items()})


def _recording_keyframe_step(captured):
    """fused.keyframe_step that keeps each capturing call's pre-eviction
    window and the capture of its record."""
    real = tfused.keyframe_step

    def wrapped(cfg, track, win, *args, capture=False, **kw):
        out = real(cfg, track, win, *args, capture=capture, **kw)
        if capture:
            rec = tfused.unpack_kf_record(out[-1].numpy(), cfg.window.max_keyframes)
            captured.append((win, rec["pair_w"]))
        return out

    return wrapped


def _check_pair_w(captured, jcfg, est):
    assert captured, "no eviction was captured"
    for win, pair_w in captured:
        ref = jmarg.window_pair_sqrt_info(_jax_window(win), jcfg, jnp.asarray(est.r_cb.numpy()),
                                          jnp.asarray(est.t_cb.numpy()))
        np.testing.assert_allclose(pair_w, np.asarray(ref), rtol=2e-3)


def _graphs_match(est, jcfg):
    """The port's export-time solve against the JAX estimator's, the JAX
    estimator fed the port's nodes, edges (``convert.edge_fields``), pose
    log and window: equal refined poses (1e-4) and Sim(3) scales."""
    jest = JaxEstimator(jcfg)
    jest.pg_nodes = list(est.pg_nodes)
    jest.pg_edges = [jest_mod.PgEdge(**convert.edge_fields(e)) for e in est.pg_edges]
    log = {k: (r.copy(), p.copy()) for k, (r, p) in est.kf_pose_log.items()}
    jest.kf_pose_log = {k: (r.copy(), p.copy()) for k, (r, p) in log.items()}
    jest.win, jest.n_kf_host = _jax_window(est.win), est.n_kf_host
    jres, tres = jest.optimize_pose_graph(), est.optimize_pose_graph()
    assert type(jres).__name__ == type(tres).__name__
    moved = [f for f in log if not np.array_equal(log[f][1], est.kf_pose_log[f][1])]
    assert moved
    for f in log:
        for a, b in zip(est.kf_pose_log[f], jest.kf_pose_log[f]):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    assert est.kf_scale_log.keys() == jest.kf_scale_log.keys()
    for f, sc in est.kf_scale_log.items():
        assert abs(sc - jest.kf_scale_log[f]) < 1e-4
    est.kf_pose_log, est.kf_scale_log = log, {}
    return type(tres).__name__


def test_estimator_pose_graph_matches_jax(monkeypatch):
    """Eviction edges with covariance weights, and the export-time SE(3)
    and Sim(3) solves, on a short VO run with a 4-keyframe window."""
    jcfg = _jax_cfg()
    cfg = port_cfg(jcfg)
    captured = []
    monkeypatch.setattr(tfused, "keyframe_step", _recording_keyframe_step(captured))
    pts = tsyn.make_point_world(11, 600, radius=(3.0, 10.0))
    rs, ts = tsyn.make_trajectory(24, step=0.11, rot_step=0.006)
    rng = np.random.default_rng(5)
    est = port_est.Estimator(cfg, device="cpu")
    for i in range(24):
        img = tsyn.render_point_image(pts, rs[i], ts[i], W, H)
        img = np.clip(img + rng.standard_normal(img.shape).astype(np.float32) * 0.01, 0, 1)
        est.process_frame(img, i * 0.1)
    assert len(est.pg_nodes) >= 2 and [e.kind for e in est.pg_edges[:2]] == ["vis", "skip"]
    _check_pair_w(captured, jcfg, est)
    for e in est.pg_edges:
        assert e.w_sqrt.shape == (6,) and np.isfinite(e.w_sqrt).all()
        assert not np.allclose(e.w_sqrt[:3], cfg.pose_graph.vis_weight_t)

    assert _graphs_match(est, jcfg) == "PoseGraphResult"  # odometry only: SE(3), window pinned

    # a loop edge from the first evicted keyframe to the newest keyframe:
    # the export switches to Sim(3) with only the first node pinned
    f0, f1 = est.pg_nodes[0], est.last_kf_fid
    (r0, t0), (r1, t1) = est.kf_pose_log[f0], est.kf_pose_log[f1]
    rel_t = r0.T @ (t1 - t0) * 1.05
    est.pg_edges.append(port_est.PgEdge(f0, f1, (r0.T @ r1).astype(np.float32),
                                        rel_t.astype(np.float32),
                                        np.float32([400.0] * 3 + [1500.0] * 3), "loop"))
    assert _graphs_match(est, jcfg) == "Sim3GraphResult"
