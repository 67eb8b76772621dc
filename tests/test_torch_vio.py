"""The port's VIO slice against the JAX package.

- ``preintegrate``, ``update_bias`` and ``predict_state`` against JAX on
  numpy-seeded IMU rows (atol 1e-5 on deltas and Jacobians; the
  covariance to rtol 1e-4);
- one module run of the VIO slice, on the 14-frame 480x240 blob sequence
  of ``vio360_tpu_torch.synthetic.make_dataset`` (the frames and IMU rows
  of tools/make_synthetic_dataset.py), through the JAX ``Estimator`` and
  through the port's CLI at ``--lk-backend matmul``. From the JAX run,
  wrappers capture the first window IMU init, the first VIBA solve, the
  state before a VIO tracking frame and the state around the first VIO
  keyframe event; the port repeats each from the converted inputs:
  - ``solve_imu_init``: gravity direction within 0.5 deg, scale within 1%;
  - ``window_viba``: final cost within 2% (as BA, tests/test_ba_pallas.py),
    poses within t 5e-3 / R 5e-4;
  - the VIO ``tracking_step``: same success and keyframe decision, inliers
    and tracked counts +-3, pose within t 5e-3 / R 5e-4;
  - the VIO keyframe event: VIBA cost within 2%, window poses within
    t 5e-3 / R 5e-4, the same refine decision;
  - the whole slice: both initialize, and initialize the IMU within +-1
    keyframe of each other; the port's SE(3) ATE <= max(1.5 x JAX,
    JAX + 0.01) and its scale error at most 2 points above JAX's.

The JAX run uses its sequential frame loop and its staged keyframe path
(``megastep`` and ``fused_keyframe`` off), which its own tests hold equal
to the fused one (tests/test_fused_keyframe.py, tests/test_megastep.py)
and which compiles in about half the time; every JAX call the checks
repeat is then one the run has compiled already. The port's CLI runs
its fused keyframe event. The checks share one
test so that xdist runs the module's two estimator runs once.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from test_torch_port import port_cfg
    from vio360_tpu import config as cfgmod
    from vio360_tpu.estimator import estimator as jest_mod, fused as jfused, window as jwin
    from vio360_tpu.imu import preintegration as jpre
    from vio360_tpu.io import dataset as jds
    from vio360_tpu.solver import imu_init as jimu_init
    from vio360_tpu.utils import metrics
except ModuleNotFoundError as e:
    # A card's machine may have no JAX: there only ``pytest -m cuda`` is meaningful.
    if e.name != "jax":
        raise
from vio360_tpu_torch import cli, convert, synthetic as tsyn
from vio360_tpu_torch.estimator import fused as tfused, window as twin
from vio360_tpu_torch.geometry import lie as tlie
from vio360_tpu_torch.imu import preintegration as tpre
from vio360_tpu_torch.solver import imu_init as timu_init

torch.set_num_threads(1)

W, H = 480, 240
N_FRAMES = 14
_YAML = """%YAML:1.0
---
camera: {width: 480, height: 240, polar_exclusion_ratio: 0.15, boundary_margin: 10}
feature_detection: {max_features: 250, quality_level: 0.02, min_distance: 10.0,
                    grid_cols: 10, grid_rows: 5, max_features_per_grid: 10}
tracking: {min_parallax_for_keyframe: 10.0}
initialization: {window_size: 8, min_parallax: 6.0, min_features: 50, min_observations: 8}
imu: {frequency: 200.0}
"""


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(state) -> dict:
    return convert.to_numpy(state)


def _angle_deg(a, b):
    c = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


# ---------------------------------------------------------------------------
# Preintegration
# ---------------------------------------------------------------------------


def test_preintegration_matches_jax():
    rng = np.random.default_rng(0)
    cap, n = 64, 41
    s = np.zeros((cap, 7), np.float32)
    s[:n, 0] = 1.3 + np.cumsum(rng.uniform(0.004, 0.006, n))
    s[:n, 1:4] = rng.normal(0, 2, (n, 3)) + [0.0, 0.0, 9.81]
    s[:n, 4:7] = rng.normal(0, 0.5, (n, 3))
    mask = np.arange(cap) < n
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.05, 0.02, -0.03], np.float32)
    ref = jpre.preintegrate(jnp.asarray(s), jnp.asarray(mask), jnp.asarray(bg), jnp.asarray(ba))
    got = tpre.preintegrate(_t(s[:n]), _t(bg), _t(ba))
    for f in dataclasses.fields(got):
        g, r = getattr(got, f.name).numpy(), np.asarray(getattr(ref, f.name))
        if f.name == "cov":
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-12, err_msg=f.name)
        else:
            np.testing.assert_allclose(g, r, atol=1e-5, err_msg=f.name)
    # one sample: the default first dt
    one = tpre.preintegrate(_t(s[:1]), _t(bg), _t(ba))
    ref1 = jpre.preintegrate(jnp.asarray(s), jnp.asarray(np.arange(cap) < 1), jnp.asarray(bg),
                             jnp.asarray(ba))
    np.testing.assert_allclose(one.dt_total.numpy(), np.asarray(ref1.dt_total), atol=1e-7)

    nbg, nba = bg + 0.003, ba - 0.01
    ref_u = jpre.update_bias(ref, jnp.asarray(nbg), jnp.asarray(nba))
    got_u = tpre.update_bias(got, _t(nbg), _t(nba))
    for name in ("delta_r", "delta_v", "delta_p", "bg", "ba"):
        np.testing.assert_allclose(getattr(got_u, name).numpy(), np.asarray(getattr(ref_u, name)),
                                   atol=1e-5, err_msg=name)
    r_i = tlie.so3_exp(torch.tensor([0.1, -0.2, 0.3])).numpy()
    t_i, v_i, g_w = (np.array(a, np.float32) for a in ([0.3, -0.1, 0.2], [0.5, 0.1, -0.2],
                                                        [0.0, 0.0, -9.81]))
    ref_p = jpre.predict_state(jnp.asarray(r_i), jnp.asarray(t_i), jnp.asarray(v_i), ref_u,
                               jnp.asarray(g_w))
    got_p = tpre.predict_state(_t(r_i), _t(t_i), _t(v_i), got_u, _t(g_w))
    for g, r in zip(got_p, ref_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


# ---------------------------------------------------------------------------
# The VIO slice: one JAX run with captures, one port CLI run
# ---------------------------------------------------------------------------


def _capture_calls(mp, module, name, store, key, keep=lambda args, kw: True):
    """Wrap ``module.name`` to store the first kept call's (args, kwargs, result)."""
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        out = orig(*args, **kw)
        if key not in store and keep(args, kw):
            store[key] = (args, kw, out)
        return out

    mp.setattr(module, name, wrapper)


def _run_jax(seq, jcfg, cap):
    est = jest_mod.Estimator(jcfg)
    orig_kf = est._create_keyframe

    def create_keyframe(timestamp, diag):
        vio = est.imu_initialized and "kf_before" not in cap
        if vio:
            rows = (np.concatenate(est.imu_since_last_kf) if est.imu_since_last_kf
                    else np.zeros((0, 7)))
            cap["kf_before"] = dict(
                convert.vio_state(est), track=est.track, win=est.win, r_cur=est.r_cur,
                t_cur=est.t_cur, n_kf_host=est.n_kf_host, rows=rows, frame_id=est.frame_id,
                timestamp=timestamp)
        out = orig_kf(timestamp, diag)
        if vio:
            cap["kf_after"] = dict(win=est.win, bg=est.bg, ba=est.ba, diag=dict(diag),
                                   refines=est.scale_refine_count)
        return out

    est._create_keyframe = create_keyframe
    results = []
    data = jds.VioDataset(str(seq), image_size=(W, H), use_native=False)
    for f in data:
        if est.imu_initialized and "track_before" not in cap:
            cap["track_before"] = dict(
                track=est.track, win=est.win, img_prev=est.img_prev, r_cur=est.r_cur,
                t_cur=est.t_cur, r_prev=est.r_prev, t_prev=est.t_prev, vel_cur=est.vel_cur,
                bg=est.bg, ba=est.ba, gravity_w=est.gravity_w, frame_id=est.frame_id,
                image=f.image, timestamp=f.timestamp, imu=f.imu)
        results.append(est.process_frame(f.image, f.timestamp, f.imu))
    return est, results


@pytest.fixture(scope="module")
def vio(tmp_path_factory):
    seq = tmp_path_factory.mktemp("vio_seq")
    gt = tsyn.make_dataset(str(seq), frames=N_FRAMES, width=W, height=H, seed=11)
    (seq / "cfg.yaml").write_text(_YAML)
    jcfg = cfgmod.load_yaml(str(seq / "cfg.yaml"))
    jcfg = dataclasses.replace(
        jcfg, loop=dataclasses.replace(jcfg.loop, enabled=False),
        pose_graph=dataclasses.replace(jcfg.pose_graph, enabled=False),
        optical_flow=dataclasses.replace(jcfg.optical_flow, backend="matmul"),
        solver=dataclasses.replace(jcfg.solver, megastep=False, fused_keyframe=False),
    )
    cap = {}
    concrete = lambda args, kw: not isinstance(args[0], jax.core.Tracer)
    with pytest.MonkeyPatch.context() as mp:
        _capture_calls(mp, jimu_init, "solve_imu_init", cap, "imu_init", concrete)
        _capture_calls(mp, jwin, "window_viba", cap, "viba")
        jax_est, jax_res = _run_jax(seq, jcfg, cap)
    traj, met = seq / "traj.tum", seq / "metrics.jsonl"
    rc = cli.main([str(seq), "--config", str(seq / "cfg.yaml"), "--no-loop", "--no-pose-graph",
                   "--lk-backend", "matmul", "--device", "cpu", "--output", str(traj),
                   "--metrics", str(met), "--quiet"])
    rows = [json.loads(ln) for ln in met.read_text().splitlines()]
    # the port runs its fused keyframe event (the JAX run's staged one is held equal to it)
    tcfg = port_cfg(jcfg)
    tcfg = dataclasses.replace(tcfg, solver=dataclasses.replace(tcfg.solver, fused_keyframe=True))
    return dict(jcfg=jcfg, tcfg=tcfg, gt=gt, cap=cap, jax=(jax_est, jax_res), rc=rc,
                frames=[r for r in rows if "frame" in r], traj=np.loadtxt(traj, ndmin=2))


def _check_imu_init(cap):
    args, kw, ref = cap["imu_init"]
    kf_r, kf_t, preints, pair_valid = args
    got = timu_init.solve_imu_init(_t(kf_r), _t(kf_t), convert.preint_from_numpy(_np(preints)),
                                   _t(pair_valid), **kw)
    assert bool(got.success) and bool(ref.success)
    assert _angle_deg(got.gravity_w.numpy(), np.asarray(ref.gravity_w)) <= 0.5
    assert abs(float(got.scale) / float(ref.scale) - 1.0) <= 0.01


def _check_viba(cap):
    args, kw, (ref_win, ref) = cap["viba"]
    win, t_bc, preints, pair_valid, g_w, bg, ba, *rest = args
    kw = {k: v for k, v in kw.items() if k != "dist_fn"}  # the sharded solve is not ported
    got_win, got = twin.window_viba(convert.window_from_numpy(_np(win)), _t(t_bc),
                                    convert.preint_from_numpy(_np(preints)), _t(pair_valid),
                                    _t(g_w), _t(bg), _t(ba), *rest, **kw)
    rc = float(ref.final_cost)
    assert abs(float(got.final_cost) - rc) <= 0.02 * rc, (float(got.final_cost), rc)
    np.testing.assert_allclose(got_win.kf_t.numpy(), np.asarray(ref_win.kf_t), atol=5e-3)
    np.testing.assert_allclose(got_win.kf_r.numpy(), np.asarray(ref_win.kf_r), atol=5e-4)


def _check_tracking_step(vio):
    jcfg, tcfg, cap = vio["jcfg"], vio["tcfg"], vio["cap"]["track_before"]
    rows = np.asarray(cap["imu"], np.float64).reshape(-1, 7)
    fcap = jcfg.imu.max_samples_per_frame
    buf = jfused.pack_frame_input(np.asarray(cap["image"], np.float32), cap["timestamp"], rows,
                                  fcap, W, frame_id=cap["frame_id"] + 1,
                                  transport=jcfg.solver.image_transport)
    t_bc = jnp.asarray(jcfg.t_bc_array())
    r_bc = t_bc[:3, :3]
    r_cb, t_cb = r_bc.T, -(r_bc.T @ t_bc[:3, 3])
    _, _, r_j, t_j, v_j, b_j = jfused.tracking_step(
        cap["track"], cap["win"], cap["img_prev"], jnp.asarray(buf), jax.random.PRNGKey(5),
        cap["r_cur"], cap["t_cur"], cap["r_prev"], cap["t_prev"], cap["vel_cur"], cap["bg"],
        cap["ba"], cap["gravity_w"], r_bc, r_cb, t_cb, jcfg, True,
    )
    b_j = jfused.unpack_bundle(np.asarray(b_j))
    _, r_t, t_t, v_t, b_t = tfused.tracking_step(
        convert.track_from_numpy(_np(cap["track"])), convert.window_from_numpy(_np(cap["win"])),
        tfused.to_device(np.array(cap["img_prev"]), "cpu"), tfused.to_device(buf, "cpu"),
        torch.Generator().manual_seed(5), _t(cap["r_cur"]), _t(cap["t_cur"]), _t(cap["r_prev"]),
        _t(cap["t_prev"]), _t(cap["vel_cur"]), _t(r_bc), _t(r_cb), _t(t_cb), tcfg,
        bg=_t(cap["bg"]), ba=_t(cap["ba"]), gravity_w=_t(cap["gravity_w"]), use_imu=True,
        n_imu=min(len(rows), fcap),
    )
    b_t = tfused.unpack_bundle(b_t.numpy())
    assert b_t["success"] == b_j["success"] and b_j["success"]
    assert b_t["is_kf"] == b_j["is_kf"]
    assert abs(b_t["n_inliers"] - b_j["n_inliers"]) <= 3
    assert abs(b_t["n_tracked"] - b_j["n_tracked"]) <= 3
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=5e-3)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=5e-4)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-4)


def _check_keyframe_event(vio):
    tcfg, before, after = vio["tcfg"], vio["cap"]["kf_before"], vio["cap"]["kf_after"]
    max_kf = tcfg.window.max_keyframes
    n_kf_after = min(before["n_kf_host"] + 1, max_kf)
    pairs_after = min(before["n_pairs"] + 1, max_kf - 1)
    assert before["imu_initialized"] and before["has_imu_stream"]
    do_refine = (before["scale_refine_count"] < tcfg.window.max_scale_refines and n_kf_after >= 3
                 and pairs_after == n_kf_after - 1)
    rows = before["rows"][-tcfg.imu.max_samples_per_keyframe:]
    out = tfused.keyframe_step(
        tcfg, convert.track_from_numpy(_np(before["track"])),
        convert.window_from_numpy(_np(before["win"])), float(before["timestamp"]),
        before["frame_id"], _t(before["r_cur"]), _t(before["t_cur"]), _t(before["vel_cur"]),
        torch.as_tensor(tcfg.t_bc_array()), use_imu=True,
        preints=convert.preint_from_numpy(before["preints"]), n_pairs=before["n_pairs"],
        was_full=before["n_kf_host"] == max_kf, do_refine=do_refine,
        imu_rows=torch.as_tensor(np.asarray(rows, np.float32)), bg=_t(before["bg"]),
        ba=_t(before["ba"]), gravity_w=_t(before["gravity_w"]),
    )
    win = out[1]
    rec = tfused.unpack_kf_record(out[-1].numpy(), max_kf)
    ref_cost = after["diag"]["ba_cost"]
    assert abs(rec["ba_cost"] - ref_cost) <= 0.02 * ref_cost, (rec["ba_cost"], ref_cost)
    assert rec["refine_applied"] == (after["refines"] > before["scale_refine_count"])
    np.testing.assert_allclose(win.kf_t.numpy(), np.asarray(after["win"].kf_t), atol=5e-3)
    np.testing.assert_allclose(win.kf_r.numpy(), np.asarray(after["win"].kf_r), atol=5e-4)


def _check_end_to_end(vio):
    """Both initialize and initialize the IMU within +-1 keyframe; SE(3) ATE
    <= max(1.5 x JAX, JAX + 0.01); scale error at most 2 points above JAX's."""
    jax_est, jax_res = vio["jax"]
    frames, gt = vio["frames"], vio["gt"]
    assert vio["rc"] == 0 and len(frames) == N_FRAMES
    assert jax_est.imu_initialized

    def kf_index_of_imu_init(keyframe_flags, imu_flags):
        kfs = [i for i, k in enumerate(keyframe_flags) if k]
        first = next(i for i, ok in enumerate(imu_flags) if ok)
        return kfs.index(first)

    k_j = kf_index_of_imu_init([r.is_keyframe for r in jax_res],
                               [bool(r.diag.get("imu_initialized")) for r in jax_res])
    k_t = kf_index_of_imu_init([r["keyframe"] for r in frames],
                               [bool(r.get("imu_initialized")) for r in frames])
    assert abs(k_t - k_j) <= 1, (k_t, k_j)
    i0 = next(r.frame_id for r in jax_res if r.state == "initialized")
    assert next(r["frame"] for r in frames if r["state"] == "initialized") == i0
    _, _, ps_j = jax_est.export_trajectory()
    ps_t = vio["traj"][:, 1:4]
    assert np.isfinite(ps_t).all() and ps_t.shape == (N_FRAMES, 3)
    p_gt = gt["p_w"]
    ate = {k: metrics.ate(p[i0:], p_gt[i0:], align="se3").rmse for k, p in (("j", ps_j), ("t", ps_t))}
    scale_err = {k: abs(metrics.ate(p[i0:], p_gt[i0:], align="sim3").scale - 1.0)
                 for k, p in (("j", ps_j), ("t", ps_t))}
    assert ate["t"] <= max(1.5 * ate["j"], ate["j"] + 0.01), ate
    assert scale_err["t"] <= scale_err["j"] + 0.02, scale_err


def test_vio_slice_matches_jax(vio):
    """One test over the module's single pair of runs: xdist hands
    consecutive tests to different workers, and each worker would
    otherwise repeat both runs."""
    _check_imu_init(vio["cap"])
    _check_viba(vio["cap"])
    _check_tracking_step(vio)
    _check_keyframe_event(vio)
    _check_end_to_end(vio)
