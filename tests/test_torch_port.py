"""The PyTorch port (``vio360_tpu_torch``) against the JAX package.

Same numpy-seeded inputs, at small sizes, go through the JAX function
and its counterpart in the port, with the JAX package's own tolerances:

- leaves: Lie group, ERP camera, reprojection factors, small linear
  algebra (atol 1e-5), essential matrix and triangulation;
- front end: pyramid and Scharr stencils, bilinear sampling, Shi-Tomasi,
  the plain twin of LK kernel K4 against ``lk.track_xla`` (< 1e-2 px on
  features both track, status count >= 0.9x, as tests/test_lk_pallas.py),
  RANSAC scoring fed the exact indices ``ransac._sample_valid`` draws
  (same inlier set, same R to 1e-5), and the JAX-free renderers of
  ``vio360_tpu_torch.synthetic`` against ``tests/synthetic.py``;
- solvers: PnP (K1) and window BA (K2, K3) through their plain twins on
  CPU tensors, against ``solve_pnp_xla``, ``solve_pnp_pallas(interpret=
  True)``, ``ba_iteration(interpret=True)`` and ``run_ba_xla`` with the
  bounds of tests/test_ba_pallas.py;
- the VO slice: ``tracking_step`` from one converted JAX state, and the
  whole CLI path end to end against the JAX ``Estimator``;
- the kernels against their plain versions on a CUDA card (marked
  ``cuda``; they skip without one), K2 at K in {1, 2, 6, 10, 16} and
  M in {1, 130, 2048} and with every landmark fixed, and K1 and K2
  returning equal tensors on two calls.

Also: the port never imports JAX or the JAX package, its entry points
run on the card unless asked for the CPU, and its CLI refuses what is
not ported with exit code 2. ``port_cfg`` builds the port's configuration
from the JAX package's (test_torch_vio.py imports it).

The suite lives in one file on purpose: where ``vio360_pytest_guard``
splits a whole-suite run into processes of at most 17 test files, every
extra file here would move the process boundaries of the existing
suite. The JAX imports are guarded so that a machine with a card and no
JAX can run the ``cuda`` tests alone (``python -m pytest
tests/test_torch_port.py -m cuda``).
Torch runs single-threaded here: the port's CPU ops are small, and
under ``pytest -n 6`` multi-threaded torch workers oversubscribe the
cores many times over.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vio360_tpu import config as cfgmod
from vio360_tpu.utils import metrics

try:
    import jax
    import jax.numpy as jnp

    import synthetic as jsyn
    from vio360_tpu.estimator import fused as jfused
    from vio360_tpu.estimator.estimator import Estimator as JaxEstimator
    from vio360_tpu.geometry import camera as jcam, essential as jess, lie as jlie
    from vio360_tpu.geometry import triangulation as jtri
    from vio360_tpu.ops import lk as jlk, pyramid as jpyr, ransac as jransac, sampling as jsamp
    from vio360_tpu.ops import shi_tomasi as jst
    from vio360_tpu.solver import ba as jba, ba_pallas, factors as jfac, linsolve as jlin, pnp as jpnp
except ModuleNotFoundError as e:
    # A card's machine may have no JAX: there only ``pytest -m cuda`` is meaningful.
    if e.name != "jax":
        raise
from vio360_tpu_torch import config as tcfg, convert, synthetic as tsyn
from vio360_tpu_torch.estimator import fused as tfused
from vio360_tpu_torch.estimator.estimator import Estimator as TorchEstimator
from vio360_tpu_torch.geometry import camera as tcam, essential as tess, lie as tlie
from vio360_tpu_torch.geometry import triangulation as ttri
from vio360_tpu_torch.ops import lk as tlk, lk_cuda, pyramid as tpyr, ransac as transac
from vio360_tpu_torch.ops import sampling as tsamp, shi_tomasi as tst
from vio360_tpu_torch.solver import ba as tba, ba_cuda, factors as tfac, linsolve as tlin
from vio360_tpu_torch.solver import pnp as tpnp

torch.set_num_threads(1)

W, H = 480, 240
ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.as_tensor(np.array(x))


def port_cfg(jax_cfg, cls=tcfg.VioConfig):
    """The port's configuration with every field it keeps taken from the
    JAX package's configuration (same names, nested dataclasses)."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(jax_cfg, f.name)
        kw[f.name] = port_cfg(v, type(f.default)) if dataclasses.is_dataclass(f.default) else v
    return cls(**kw)


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# Leaves: geometry, factors, linear algebra
# ---------------------------------------------------------------------------


def _phis(n=16, seed=0):
    rng = _rng(seed)
    phi = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    phi[0] = 0.0
    phi[1] = [1e-7, -2e-7, 5e-8]
    phi[2] = [0.0, 0.0, np.pi - 1e-4]
    return phi


def _case_lie():
    phi = _phis()
    r_j = np.asarray(jlie.so3_exp_b(jnp.asarray(phi)))
    r_t = tlie.so3_exp(_t(phi)).numpy()
    np.testing.assert_allclose(r_t, r_j, atol=ATOL)
    np.testing.assert_allclose(tlie.so3_log(_t(r_j)).numpy(), np.asarray(jlie.so3_log_b(jnp.asarray(r_j))), atol=1e-4)
    xi = _rng(1).normal(0, 0.5, (16, 6)).astype(np.float32)
    rj, tj = jlie.se3_exp_b(jnp.asarray(xi))
    rt, tt = tlie.se3_exp(_t(xi))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=ATOL)
    noisy = r_j + _rng(2).normal(0, 1e-3, r_j.shape).astype(np.float32)
    np.testing.assert_allclose(tlie.so3_renormalize(_t(noisy)).numpy(),
                               np.asarray(jlie.so3_renormalize(jnp.asarray(noisy))), atol=ATOL)
    ri, ti = jlie.interpolate_pose(jnp.asarray(r_j[3]), jnp.asarray(tj[3]), jnp.asarray(r_j[4]),
                                   jnp.asarray(tj[4]), 0.3)
    ri_t, ti_t = tlie.interpolate_pose(_t(r_j[3]), _t(np.asarray(tj[3])), _t(r_j[4]),
                                       _t(np.asarray(tj[4])), 0.3)
    np.testing.assert_allclose(ri_t.numpy(), np.asarray(ri), atol=ATOL)
    np.testing.assert_allclose(ti_t.numpy(), np.asarray(ti), atol=ATOL)


def _points(n=64, seed=3):
    rng = _rng(seed)
    return (rng.normal(0, 1, (n, 3)) * rng.uniform(1, 8, (n, 1))).astype(np.float32)


def _case_camera():
    rng = _rng(4)
    uv = np.stack([rng.uniform(-5, W + 5, 64), rng.uniform(0, H, 64)], -1).astype(np.float32)
    np.testing.assert_allclose(tcam.pixel_to_bearing(_t(uv), W, H).numpy(),
                               np.asarray(jcam.pixel_to_bearing(jnp.asarray(uv), W, H)), atol=ATOL)
    p = _points()
    np.testing.assert_allclose(tcam.bearing_to_pixel(_t(p), W, H).numpy() / W,
                               np.asarray(jcam.bearing_to_pixel(jnp.asarray(p), W, H)) / W, atol=ATOL)
    np.testing.assert_allclose(tcam.projection_jacobian(_t(p), W, H).numpy(),
                               np.asarray(jcam.projection_jacobian(jnp.asarray(p), W, H)), atol=1e-3, rtol=1e-5)
    du = rng.uniform(-2 * W, 2 * W, 64).astype(np.float32)
    np.testing.assert_allclose(tcam.wrap_residual_u(_t(du), W).numpy(),
                               np.asarray(jcam.wrap_residual_u(jnp.asarray(du), W)), atol=1e-3)
    x = rng.uniform(-3 * W, 3 * W, 64).astype(np.float32)
    np.testing.assert_array_equal(tcam.fmod_positive(_t(x), float(W)).numpy(), np.asarray(jnp.mod(jnp.asarray(x), W)))


def _case_factors():
    rng = _rng(5)
    k, m = 3, 40
    rs = np.asarray(jlie.so3_exp_b(jnp.asarray(rng.normal(0, 0.1, (k, 3)).astype(np.float32))))
    ts = rng.normal(0, 0.3, (k, 3)).astype(np.float32)
    r_cb = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.01, 0.03], jnp.float32)))
    t_cb = np.asarray([0.01, 0.0, -0.02], np.float32)
    pts = _points(m, 6) + np.asarray([0, 0, 6.0], np.float32)
    pb_j, pc_j = jfac.transform_points(*(jnp.asarray(a) for a in (rs, ts, r_cb, t_cb, pts)))
    pb_t, pc_t = tfac.transform_points(*(_t(a) for a in (rs, ts, r_cb, t_cb, pts)))
    np.testing.assert_allclose(pc_t.numpy(), np.asarray(pc_j), atol=ATOL * 10)
    jp_j, jl_j = jfac.reprojection_jacobians(pb_j, pc_j, jnp.asarray(rs)[:, None], jnp.asarray(r_cb), W, H)
    jp_t, jl_t = tfac.reprojection_jacobians(_t(np.asarray(pb_j)), _t(np.asarray(pc_j)), _t(rs)[:, None], _t(r_cb), W, H)
    np.testing.assert_allclose(jp_t.numpy(), np.asarray(jp_j), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(jl_t.numpy(), np.asarray(jl_j), atol=1e-4, rtol=1e-5)
    obs = np.asarray(jcam.project(pc_j, W, H)) + rng.normal(0, 3, (k, m, 2)).astype(np.float32)
    res_j = jfac.reprojection_residual(pc_j, jnp.asarray(obs), W, H)
    res_t = tfac.reprojection_residual(_t(np.asarray(pc_j)), _t(obs), W, H)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), atol=1e-3)
    act = rng.random((k, m)) < 0.8
    w_j = jfac.robust_weights(res_j, jnp.asarray(act), 1.0, 1.0)
    w_t = tfac.robust_weights(_t(np.asarray(res_j)), _t(act), 1.0, 1.0)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=ATOL)


def _case_linsolve():
    rng = _rng(7)
    a = rng.normal(0, 1, (12, 12)).astype(np.float32)
    a = a @ a.T + 12 * np.eye(12, dtype=np.float32)
    b = rng.normal(0, 1, 12).astype(np.float32)
    np.testing.assert_allclose(tlin.solve(_t(a), _t(b)).numpy(),
                               np.asarray(jlin.solve(jnp.asarray(a), jnp.asarray(b))), atol=ATOL)
    m3 = rng.normal(0, 1, (20, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tlin.inv3x3(_t(m3)).numpy(), np.asarray(jlin.inv3x3(jnp.asarray(m3))), atol=ATOL)
    mm = np.moveaxis(m3, 0, -1).copy()
    np.testing.assert_allclose(tlin.inv3x3_mminor(_t(mm)).numpy(),
                               np.asarray(jlin.inv3x3_mminor(jnp.asarray(mm))), atol=ATOL)


def _two_view(seed=8, n=60):
    rng = _rng(seed)
    p1 = _points(n, seed) + np.asarray([0.0, 0.0, 0.5], np.float32)
    r21 = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.03], jnp.float32)))
    t21 = np.asarray([0.3, 0.05, -0.1], np.float32)
    p2 = p1 @ r21.T + t21
    b1 = p1 / np.linalg.norm(p1, axis=1, keepdims=True)
    b2 = p2 / np.linalg.norm(p2, axis=1, keepdims=True)
    b1 = b1 + rng.normal(0, 1e-4, b1.shape).astype(np.float32)
    return b1.astype(np.float32), b2.astype(np.float32), r21, t21


def _case_essential():
    b1, b2, r21, t21 = _two_view()
    e_j = np.asarray(jess.solve_eight_point(jnp.asarray(b1), jnp.asarray(b2)))
    e_t = tess.solve_eight_point(_t(b1), _t(b2)).numpy()
    sign = np.sign((e_j * e_t).sum())
    np.testing.assert_allclose(e_t * sign, e_j, atol=1e-4)
    np.testing.assert_allclose(tess.epipolar_errors(_t(e_j), _t(b1), _t(b2)).numpy(),
                               np.asarray(jess.epipolar_errors(jnp.asarray(e_j), jnp.asarray(b1), jnp.asarray(b2))), atol=ATOL)
    rs_j, ts_j = jess.decompose_essential(jnp.asarray(e_j))
    rs_t, ts_t = tess.decompose_essential(_t(e_j))
    cand_j = {(tuple(np.round(r, 3).ravel()), tuple(np.round(t, 3))) for r, t in zip(np.asarray(rs_j), np.asarray(ts_j))}
    cand_t = {(tuple(np.round(r, 3).ravel()), tuple(np.round(t, 3))) for r, t in zip(rs_t.numpy(), ts_t.numpy())}
    assert cand_j == cand_t


def _case_triangulation():
    b1, b2, r21, t21 = _two_view(9)
    pj, vj = jtri.triangulate_midpoint(*(jnp.asarray(a) for a in (b1, b2, r21, t21)))
    pt, vt = ttri.triangulate_midpoint(*(_t(a) for a in (b1, b2, r21, t21)))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # near-parallel rays amplify float32 rounding through Cramer's rule
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3, rtol=1e-2)
    t1w = np.eye(4, dtype=np.float32)
    t2w = np.eye(4, dtype=np.float32)
    t2w[:3, :3], t2w[:3, 3] = r21, t21
    pj, vj = jtri.triangulate_dlt(*(jnp.asarray(a) for a in (b1, b2, t1w, t2w)))
    pt, vt = ttri.triangulate_dlt(*(_t(a) for a in (b1, b2, t1w, t2w)))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # float32 SVD of the 4x4 DLT system: distant points are ill-conditioned
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3, rtol=1e-2)


_CASES = {
    "lie": _case_lie, "camera": _case_camera, "factors": _case_factors,
    "linsolve": _case_linsolve, "essential": _case_essential, "triangulation": _case_triangulation,
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_leaf_matches_jax(name):
    _CASES[name]()


def _runs_repo_scripts(source: str) -> list[int]:
    """Lines of ``source`` with a ``subprocess`` call that is handed
    ``sys.executable``: a Python script run in a subprocess, whose imports
    the import check below cannot see."""
    import ast

    def names_subprocess(f):
        while isinstance(f, ast.Attribute):
            f = f.value
        return isinstance(f, ast.Name) and f.id == "subprocess"

    return [n.lineno for n in ast.walk(ast.parse(source))
            if isinstance(n, ast.Call) and names_subprocess(n.func)
            and any(isinstance(a, ast.Attribute) and a.attr == "executable"
                    and isinstance(a.value, ast.Name) and a.value.id == "sys"
                    for a in ast.walk(n))]


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import neither JAX nor
    any module of the JAX package, and chip_smoke.py runs no Python script
    of the repo in a subprocess."""
    code = (
        "import sys, importlib, pkgutil, vio360_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'vio360_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if k.startswith('jax'))\n"
        "bad = sorted(k for k in sys.modules if k == 'vio360_tpu' or k.startswith('vio360_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
    # the check sees the evaluator call chip_smoke.py used to make
    assert _runs_repo_scripts("import subprocess, sys\nsubprocess.run([sys.executable, "
                              "'tools/evaluate_ate.py', 'a', 'b'], check=True)\n") == [2]
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert _runs_repo_scripts(f.read()) == []


_CLI_CFG = os.path.join(REPO, "configs", "synthetic_480.yaml")
_CLI_OFF = ["--no-loop", "--no-pose-graph"]


@pytest.mark.parametrize("extra,needle", [
    ([], None),  # the defaults: loop closure and pose graph on
    (["--no-loop"], None),
    (_CLI_OFF + ["--mesh", "lm=2"], "--mesh"),
    (_CLI_OFF + ["--frames-per-dispatch", "4"], "batched dispatch"),
    (_CLI_OFF + ["--x64"], "--x64"),
    (_CLI_OFF + ["--checkpoint", "c.npz"], "run:checkpoint"),
    (_CLI_OFF + ["--resume", "c.npz"], "run:resume"),
    (_CLI_OFF + ["--checkpoint", "c.npz", "--checkpoint-every", "1"], "run:checkpoint"),
    (_CLI_OFF + ["--step"], "run:step"),
    (_CLI_OFF + ["--pause-on-init"], "run:one"),
    (_CLI_OFF + ["--profile", "prof"], "run:profile"),
    (_CLI_OFF + ["--no-pipelined"], "run:one"),
    (_CLI_OFF + ["--solver-backend", "auto"], "run:one"),
    (_CLI_OFF + ["--solver-backend", "xla"], "--solver-backend xla"),
    (_CLI_OFF + ["--solver-backend", "pallas-interpret"], "--solver-backend pallas-interpret"),
    (_CLI_OFF + ["--viz-dir", "viz"], "--viz-dir"),
    (_CLI_OFF + ["--viz-fps", "10"], "--viz-fps"),
])
def test_cli_refuses_unported(tmp_path, capsys, monkeypatch, extra, needle):
    """Unported flags exit 2 and name the part; the defaults and
    ``--no-loop`` (loop closure and pose graph ported) run to the end on a
    tiny CPU sequence; the ported host-loop flags run (on the first frame,
    or both for ``--resume`` and ``--step``) and leave their output:
    a checkpoint that loads at its frame, a resumed run that continues at
    the next frame, a ``--step`` run that the prompt quits after frame 0,
    a profiler trace."""
    from vio360_tpu_torch import cli

    os.makedirs(tmp_path / "images")
    for i in range(2):
        np.save(tmp_path / "images" / f"{i:06d}.npy", _image(i)[0])
    (tmp_path / "cam_timestamps.txt").write_text("0.0\n0.1\n")
    (tmp_path / "imu_data.csv").write_text("timestamp,ax,ay,az,gx,gy,gz\n0.0,0,0,9.81,0,0,0\n")
    extra = [str(tmp_path / a) if a in ("c.npz", "prof", "viz") else a for a in extra]
    out = tmp_path / "traj.tum"
    if needle is None:
        assert cli.main([str(tmp_path), *extra, "--device", "cpu", "--output", str(out),
                         "--quiet"]) == 0
        assert len(out.read_text().splitlines()) == 2
        return
    if not needle.startswith("run:"):
        assert cli.main([str(tmp_path), *extra]) == 2
        err = capsys.readouterr().err
        assert "not ported" in err and needle in err, err
        return
    kind = needle[4:]
    base = [str(tmp_path), "--config", _CLI_CFG, "--device", "cpu", "--output", str(out), "--quiet"]
    one = [] if kind in ("resume", "step") else ["--max-frames", "1"]
    ck = tmp_path / "c.npz"
    if kind == "resume":
        assert cli.main(base + _CLI_OFF + ["--max-frames", "1", "--checkpoint", str(ck)]) == 0
    monkeypatch.setattr(sys, "stdin", io.StringIO("q\n" if kind == "step" else ""))
    met = tmp_path / "m.jsonl"
    assert cli.main(base + extra + one + ["--metrics", str(met)]) == 0
    frames = [r["frame"] for r in map(json.loads, met.read_text().splitlines())
              if "frame" in r]
    n_lines = len(out.read_text().splitlines())
    if kind == "checkpoint":
        cfg = dataclasses.replace(tcfg.load_yaml(_CLI_CFG), loop=tcfg.LoopConfig(enabled=False),
                                  pose_graph=tcfg.PoseGraphConfig(enabled=False))
        assert TorchEstimator.load(str(ck), cfg, device="cpu").frame_id == 0
    if kind == "resume":
        assert frames == [1] and n_lines == 2
    else:
        assert frames == [0] and n_lines == 1
    if kind == "profile":
        with open(tmp_path / "prof" / "trace.json") as f:
            assert json.load(f)["traceEvents"]


def test_entry_points_refuse_without_a_card(tmp_path, capsys, monkeypatch):
    """With no card, the estimator and the CLI run only when asked for the CPU."""
    from vio360_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.VioConfig(loop=tcfg.LoopConfig(enabled=False),
                         pose_graph=tcfg.PoseGraphConfig(enabled=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEstimator(cfg)
    assert TorchEstimator(cfg, device="cpu").device.type == "cpu"
    os.makedirs(tmp_path / "images")
    np.save(tmp_path / "images" / "000000.npy", np.zeros((H, W), np.float32))
    (tmp_path / "cam_timestamps.txt").write_text("0.0\n")
    assert cli.main([str(tmp_path), "--no-loop", "--no-pose-graph"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Front end
# ---------------------------------------------------------------------------


def _image(seed=0, h=H, w=W):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.random((h + 8, w + 8)).astype(np.float32), 2.0)
    return base[:h, :w], base[2:2 + h, 1:1 + w]


def test_pyramid_and_gradients_match_jax():
    img, _ = _image()
    pj = jpyr.build_pyramid(jnp.asarray(img), 3)
    pt = tpyr.build_pyramid(_t(img), 3)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        for ga, gb in zip(tpyr.scharr_gradients(a), jpyr.scharr_gradients(b)):
            np.testing.assert_allclose(ga.numpy(), np.asarray(gb), atol=1e-6)


def test_bilinear_sample_matches_jax():
    img, _ = _image(1)
    rng = np.random.default_rng(2)
    uv = np.stack([rng.uniform(-30, W + 30, 500), rng.uniform(-3, H + 3, 500)], -1).astype(np.float32)
    np.testing.assert_allclose(tsamp.bilinear_sample(_t(img), _t(uv)).numpy(),
                               np.asarray(jsamp.bilinear_sample(jnp.asarray(img), jnp.asarray(uv))), atol=1e-6)


def test_shi_tomasi_detect_matches_jax():
    img, _ = _image(3)
    mask = np.asarray(jcam.polar_mask(W, H, 0.15))
    rng = np.random.default_rng(4)
    ex_uv = np.stack([rng.uniform(0, W, 40), rng.uniform(0, H, 40)], -1).astype(np.float32)
    ex_valid = rng.random(40) < 0.5
    uj, sj, vj = jst.detect(jnp.asarray(img), jnp.asarray(mask), jnp.asarray(ex_uv), jnp.asarray(ex_valid),
                            max_new=256, min_distance=10.0, quality_level=0.01)
    ut, stt, vt = tst.detect(_t(img), _t(mask), _t(ex_uv), _t(ex_valid), max_new=256, min_distance=10.0,
                             quality_level=0.01)
    vj, vt = np.asarray(vj), vt.numpy()
    assert vt.sum() > 50
    # Both box-filter through a cumsum over the whole image, which XLA and
    # torch accumulate in different orders (~1e-3 relative on the
    # response), so a marginal NMS / quality-threshold peak may flip: the
    # detected sets agree up to 2%, and common detections score alike.
    set_j = {tuple(p) for p in np.asarray(uj)[vj].tolist()}
    set_t = {tuple(p) for p in ut.numpy()[vt].tolist()}
    assert len(set_j ^ set_t) <= 0.02 * len(set_j), (len(set_j), len(set_t), len(set_j ^ set_t))
    score_j = dict(zip(map(tuple, np.asarray(uj)[vj].tolist()), np.asarray(sj)[vj]))
    for p, s in zip(map(tuple, ut.numpy()[vt].tolist()), stt.numpy()[vt]):
        if p in score_j:
            np.testing.assert_allclose(s, score_j[p], rtol=5e-3)


@pytest.mark.parametrize("with_guess", [False, True])
def test_lk_plain_matches_track_xla(with_guess):
    img0, img1 = _image(5)
    rng = np.random.default_rng(3)
    n = 128
    uv = np.stack([rng.uniform(30, W - 30, n), rng.uniform(40, H - 40, n)], -1).astype(np.float32)
    valid = rng.random(n) < 0.95
    guess = (uv + np.asarray([-0.7, -1.6], np.float32)) if with_guess else None
    uj, sj, ej = jlk.track_xla(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(uv), jnp.asarray(valid),
                               None if guess is None else jnp.asarray(guess))
    ut, st, et = tlk.track(_t(img0), _t(img1), _t(uv), _t(valid), None if guess is None else _t(guess))
    sj, st = np.asarray(sj), st.numpy()
    assert st.sum() >= 0.9 * sj.sum() and sj.sum() > 0.8 * n
    both = sj & st
    assert np.abs(ut.numpy() - np.asarray(uj))[both].max() < 1e-2
    np.testing.assert_allclose(et.numpy()[both], np.asarray(ej)[both], atol=1e-4)
    np.testing.assert_allclose(np.median(ut.numpy()[both] - uv[both], 0), [-1.0, -2.0], atol=0.1)
    # failed features stay at their previous position
    np.testing.assert_array_equal(ut.numpy()[~st], uv[~st])


def _bearing_pairs(seed, n=256, outliers=40):
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(0, W, n), rng.uniform(40, H - 40, n)], -1).astype(np.float32)
    b1 = np.asarray(jcam.pixel_to_bearing(jnp.asarray(uv), W, H))
    r = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.01], jnp.float32)))
    b2 = b1 @ r.T
    b2[:outliers] = np.asarray(jcam.pixel_to_bearing(jnp.asarray(uv[:outliers] + 25.0), W, H))
    b2 = b2 + rng.normal(0, 1e-4, b2.shape).astype(np.float32)
    b2 /= np.linalg.norm(b2, axis=1, keepdims=True)
    valid = rng.random(n) < 0.9
    return b1.astype(np.float32), b2.astype(np.float32), valid


def test_rotation_ransac_with_injected_indices():
    b1, b2, valid = _bearing_pairs(6)
    key = jax.random.PRNGKey(7)
    thr = float(np.deg2rad(2.0))
    rj, inl_j, nj = jransac.rotation_ransac(key, jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(valid),
                                             threshold_rad=thr, iterations=300)
    idx = jransac._sample_valid(key, jnp.asarray(valid), (300, 3))
    rt, inl_t, nt = transac.rotation_ransac_score(_t(np.asarray(idx)).long(), _t(b1), _t(b2), _t(valid), thr)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(nt) == int(nj)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)


def test_essential_ransac_with_injected_indices():
    rng = np.random.default_rng(8)
    n = 256
    p1 = rng.normal(0, 1, (n, 3)) * rng.uniform(2, 8, (n, 1))
    r21 = np.asarray(jlie.so3_exp(jnp.asarray([0.03, -0.08, 0.02], jnp.float32)))
    t21 = np.asarray([0.4, 0.05, -0.1])
    p2 = p1 @ r21.T + t21
    b1 = (p1 / np.linalg.norm(p1, axis=1, keepdims=True)).astype(np.float32)
    b2 = (p2 / np.linalg.norm(p2, axis=1, keepdims=True)).astype(np.float32)
    b2[:30] = b2[30:60]  # gross mismatches
    valid = rng.random(n) < 0.9
    key = jax.random.PRNGKey(3)
    ej, inl_j, nj = jransac.essential_ransac(key, jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(valid),
                                              threshold=0.01, iterations=100)
    idx = jransac._sample_valid(key, jnp.asarray(valid), (100, 8))
    et, inl_t, nt = transac.essential_ransac_score(_t(np.asarray(idx)).long(), _t(b1), _t(b2), _t(valid), 0.01)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(nt) == int(nj)
    ej = np.asarray(ej)
    sign = np.sign((ej * et.numpy()).sum())
    np.testing.assert_allclose(et.numpy() * sign, ej, atol=1e-4)


def test_sample_valid_draws_only_valid_entries():
    valid = torch.zeros(300, dtype=torch.bool)
    valid[torch.arange(5, 300, 7)] = True
    gen = torch.Generator().manual_seed(0)
    idx = transac.sample_valid(gen, valid, (2000, 3))
    assert valid[idx].all()
    assert len(torch.unique(idx)) == int(valid.sum())
    np.testing.assert_array_equal(transac.compact_indices(valid, -1).numpy(),
                                  np.asarray(jnp.nonzero(jnp.asarray(valid.numpy()), size=300, fill_value=-1)[0]))


def test_synthetic_renderers_match_jax():
    pj = np.asarray(jsyn.make_panorama(5, 120, 240))
    pt = tsyn.make_panorama(5, 120, 240).numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    r = np.asarray(jlie.so3_exp(jnp.asarray([0.05, 0.3, -0.02], jnp.float32)))
    t = np.asarray([0.3, -0.2, 0.4], np.float32)
    vj = np.asarray(jsyn.render_textured_view(jnp.asarray(pj), jnp.asarray(r), jnp.asarray(t), 240, 120))
    vt = tsyn.render_textured_view(_t(pj), _t(r), _t(t), 240, 120).numpy()
    assert np.abs(vt - vj).mean() < 1e-5 and np.abs(vt - vj).max() < 2e-3
    rs_j, ts_j = jsyn.make_trajectory(10, step=0.12, rot_step=0.004)
    rs_t, ts_t = tsyn.make_trajectory(10, step=0.12, rot_step=0.004)
    np.testing.assert_allclose(rs_t, rs_j, atol=1e-5)
    np.testing.assert_allclose(ts_t, ts_j, atol=1e-5)
    pts = tsyn.make_point_world(11, 300, radius=(3.0, 10.0))
    np.testing.assert_array_equal(pts, jsyn.make_point_world(11, 300, radius=(3.0, 10.0)))
    bj = np.asarray(jsyn.render_point_image(pts, rs_j[5], ts_j[5], 240, 120))
    bt = tsyn.render_point_image(pts, rs_j[5], ts_j[5], 240, 120)
    np.testing.assert_allclose(bt, bj, atol=1e-4)


# ---------------------------------------------------------------------------
# Solvers: PnP (K1) and window BA (K2, K3) on CPU tensors
# ---------------------------------------------------------------------------

K, M = 6, 256


def _ba_problem(seed=0, noise=0.5):
    """The problem of tests/test_ba_pallas.py::_problem."""
    rng = np.random.default_rng(seed)
    pts = jnp.asarray(rng.uniform(-5, 5, (M, 3)) + np.array([0, 0, 7.0]), jnp.float32)
    angles = rng.uniform(-0.05, 0.05, (K, 3)).astype(np.float32)
    rs = jnp.stack([jlie.so3_exp(jnp.asarray(a)) for a in angles])
    ts = jnp.asarray(np.cumsum(rng.uniform(-0.05, 0.08, (K, 3)), 0), jnp.float32)
    r_cb = jlie.so3_exp(jnp.asarray([0.02, -0.01, 0.03]))
    t_cb = jnp.asarray([0.01, 0.0, -0.02])
    p_b = jnp.einsum("kji,mj->kmi", rs, pts) - jnp.einsum("kji,kj->ki", rs, ts)[:, None]
    p_c = jnp.einsum("ij,kmj->kmi", r_cb, p_b) + t_cb
    uv = jcam.project(p_c, W, H) + jnp.asarray(rng.standard_normal((K, M, 2)) * noise, jnp.float32)
    mask = jnp.asarray(rng.random((K, M)) < 0.7)
    fixed_pose = jnp.zeros(K, bool).at[0].set(True)
    fixed_point = jnp.asarray(rng.random(M) < 0.1)
    return rs, ts, pts, uv, mask, fixed_pose, fixed_point, r_cb, t_cb


def _pnp_problem(seed=9, n=256):
    """The problem of tests/test_ba_pallas.py::test_solve_pnp_pallas_matches_xla,
    plus inactive and marginalized slots."""
    rng = np.random.default_rng(seed)
    pts = jnp.asarray(rng.uniform(-5, 5, (n, 3)) + np.array([0, 0, 7.0]), jnp.float32)
    r_true = jlie.so3_exp(jnp.asarray([0.03, -0.02, 0.01]))
    t_true = jnp.asarray([0.15, -0.1, 0.2])
    r_cb = jlie.so3_exp(jnp.asarray([0.01, 0.02, -0.01]))
    t_cb = jnp.asarray([0.02, 0.01, 0.0])
    p_c = ((pts - t_true) @ r_true) @ r_cb.T + t_cb
    uv = jcam.project(p_c, W, H) + jnp.asarray(rng.standard_normal((n, 2)) * 0.5, jnp.float32)
    out_idx = rng.choice(n, 20, replace=False)
    uv = uv.at[out_idx].add(jnp.asarray(rng.uniform(30, 60, (20, 2)), jnp.float32))
    active = jnp.asarray(rng.random(n) < 0.9)
    marg = jnp.asarray(rng.random(n) < 0.05)
    return pts, uv, active, marg, r_cb, t_cb, t_true


@pytest.mark.parametrize("port_fn", ["solve_pnp", "solve_pnp_xla"])
def test_pnp_matches_jax(port_fn):
    pts, uv, active, marg, r_cb, t_cb, t_true = _pnp_problem()
    args = (jnp.eye(3), jnp.zeros(3), pts, uv, active, marg, r_cb, t_cb, W, H)
    refs = [jpnp.solve_pnp_xla(*args), jpnp.solve_pnp_pallas(*args, interpret=True)]
    got = getattr(tpnp, port_fn)(torch.eye(3), torch.zeros(3), _t(pts), _t(uv), _t(active), _t(marg),
                                 _t(r_cb), _t(t_cb), W, H)
    assert bool(got.success)
    for ref in refs:
        assert bool(ref.success)
        np.testing.assert_allclose(got.t_wb.numpy(), np.asarray(ref.t_wb), atol=5e-3)
        np.testing.assert_allclose(got.r_wb.numpy(), np.asarray(ref.r_wb), atol=5e-4)
        assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 3
    np.testing.assert_allclose(got.t_wb.numpy(), np.asarray(t_true), atol=2e-2)
    # marginalized landmarks are never outliers
    assert not (got.outlier.numpy() & np.asarray(marg)).any()


def test_pnp_failure_keeps_prediction():
    pts, uv, active, marg, r_cb, t_cb, _ = _pnp_problem(seed=2)
    active = np.zeros(active.shape, bool)
    active[:5] = True  # < 6 active observations
    r0 = jlie.so3_exp(jnp.asarray([0.01, 0.02, 0.0]))
    got = tpnp.solve_pnp(_t(r0), torch.ones(3), _t(pts), _t(uv), _t(active), _t(marg), _t(r_cb), _t(t_cb), W, H)
    assert not bool(got.success)
    np.testing.assert_allclose(got.t_wb.numpy(), np.ones(3))
    np.testing.assert_allclose(got.r_wb.numpy(), np.asarray(r0), atol=1e-6)


@pytest.mark.parametrize("lam", [1e-4, 1e-1])
def test_ba_iteration_matches_pallas(lam):
    rs, ts, pts, uv, mask, fp, fpt, r_cb, t_cb = _ba_problem()
    obs_w = mask.astype(jnp.float32)
    ref = ba_pallas.ba_iteration(rs, ts, pts, uv, obs_w, fp, fpt, jnp.asarray(lam, jnp.float32),
                                 r_cb, t_cb, W, H, interpret=True)
    got = ba_cuda.ba_iteration(_t(rs), _t(ts), _t(pts), _t(uv), _t(obs_w), _t(fp), _t(fpt), lam,
                               _t(r_cb), _t(t_cb), W, H)
    for name, g, r in zip(["r", "t", "pts", "cur_cost", "new_cost", "step"], got, ref):
        g, r = g.numpy(), np.asarray(r)
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=2e-3 * scale, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("port_fn", ["run_ba", "run_ba_xla"])
def test_ba_full_solve_cost_matches_xla(port_fn):
    rs, ts, pts, uv, mask, fp, fpt, r_cb, t_cb = _ba_problem(seed=5)
    ts_p = ts + jnp.asarray(np.random.default_rng(6).normal(0, 0.03, ts.shape), jnp.float32)
    marg = jnp.zeros(M, bool)
    ref = jba.run_ba_xla(rs, ts_p, pts, uv, mask, fp, fpt, marg, r_cb, t_cb, width=W, height=H,
                         max_iterations=8)
    got = getattr(tba, port_fn)(_t(rs), _t(ts_p), _t(pts), _t(uv), _t(mask), _t(fp), _t(fpt),
                                _t(marg), _t(r_cb), _t(t_cb), W, H, max_iterations=8)
    *_, cost = tba._evaluate(got.r_wb, got.t_wb, got.points, _t(uv), _t(mask), _t(r_cb), _t(t_cb),
                             W, H, 1.0, 1.0)
    ref_cost = float(ref.final_cost)
    assert abs(float(cost) - ref_cost) < 0.02 * ref_cost
    assert abs(float(got.final_cost) - ref_cost) < 0.02 * ref_cost
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 3
    # fixed pose and fixed landmarks do not move
    np.testing.assert_allclose(got.r_wb[0].numpy(), np.asarray(rs)[0], atol=1e-6)
    moved = np.abs(got.points.numpy() - np.asarray(pts)).max(1)
    assert (moved[np.asarray(fpt)] < 1e-7).all()


# ---------------------------------------------------------------------------
# The VO slice against the JAX Estimator
# ---------------------------------------------------------------------------

N_FRAMES = 24
CAPTURE_AFTER = 12  # frame whose pre-step state the tracking_step check replays


def _slice_cfg():
    """The tests/test_e2e_vo.py configuration with the slice's switches:
    no loop closure, no pose graph, sequential frames."""
    cfg = cfgmod.VioConfig(
        camera=cfgmod.CameraConfig(width=W, height=H, boundary_margin=10.0),
        features=cfgmod.FeatureConfig(max_features=250, capacity=256, min_distance=10.0,
                                      quality_level=0.02, grid_cols=10, grid_rows=5,
                                      max_features_per_grid=10),
        ransac=cfgmod.RansacConfig(max_iterations=300),
        init=cfgmod.InitializationConfig(window_size=8, min_features=50, min_observations=8,
                                         min_parallax=8.0),
        tracking=cfgmod.TrackingConfig(min_parallax_for_keyframe=12.0),
        window=cfgmod.WindowConfig(max_keyframes=6, max_landmarks=512),
    )
    return dataclasses.replace(
        cfg,
        loop=dataclasses.replace(cfg.loop, enabled=False),
        pose_graph=dataclasses.replace(cfg.pose_graph, enabled=False),
        solver=dataclasses.replace(cfg.solver, megastep=False),
    )


def _run(est, images, capture=None):
    results = []
    for i, img in enumerate(images):
        if capture is not None and i == CAPTURE_AFTER:
            capture.update(
                track=est.track, win=est.win, img_prev=est.img_prev, r_cur=est.r_cur,
                t_cur=est.t_cur, r_prev=est.r_prev, t_prev=est.t_prev, frame_id=est.frame_id,
            )
        results.append(est.process_frame(img, i * 0.1))
    return results


@pytest.fixture(scope="module")
def runs():
    pts = jsyn.make_point_world(11, 500, radius=(3.0, 10.0))
    rs, ts = jsyn.make_trajectory(N_FRAMES, step=0.12, rot_step=0.004)
    images = [np.asarray(jsyn.render_point_image(pts, rs[i], ts[i], W, H)) for i in range(N_FRAMES)]
    cfg = _slice_cfg()
    jax_est = JaxEstimator(cfg)
    captured = {}
    jax_res = _run(jax_est, images, captured)
    torch_est = TorchEstimator(port_cfg(cfg), device="cpu")
    torch_res = _run(torch_est, images)
    return dict(cfg=cfg, images=images, ts=ts, jax=(jax_est, jax_res), torch=(torch_est, torch_res),
                captured=captured)


def _init_frame(results):
    return next(r.frame_id for r in results if r.state == "initialized")


def _ate(results, ts):
    i0 = _init_frame(results)
    return metrics.ate(np.stack([r.t_wb for r in results[i0:]]), ts[i0:], align="sim3").rmse


def _check_tracking_step(runs):
    """tracking_step from one converted JAX state and image pair: same
    success and keyframe decision, inliers +-3, PnP pose within t 5e-3 /
    R 5e-4. RANSAC draws from different generators on the two sides."""
    cfg, cap = runs["cfg"], runs["captured"]
    assert cap and runs["jax"][0].initialized
    img = runs["images"][CAPTURE_AFTER]
    buf = jfused.pack_frame_input(img, CAPTURE_AFTER * 0.1, None, cfg.imu.max_samples_per_frame, W,
                                  frame_id=cap["frame_id"] + 1, transport=cfg.solver.image_transport)
    t_bc = jnp.asarray(cfg.t_bc_array())
    r_bc = t_bc[:3, :3]
    r_cb, t_cb = r_bc.T, -(r_bc.T @ t_bc[:3, 3])
    z3 = jnp.zeros(3)
    _, _, r_j, t_j, _, b_j = jfused.tracking_step(
        cap["track"], cap["win"], cap["img_prev"], jnp.asarray(buf), jax.random.PRNGKey(5),
        cap["r_cur"], cap["t_cur"], cap["r_prev"], cap["t_prev"], z3, z3, z3,
        jnp.asarray([0.0, 0.0, -9.81]), r_bc, r_cb, t_cb, cfg, False,
    )
    b_j = jfused.unpack_bundle(np.asarray(b_j))

    track = convert.track_from_numpy(convert.to_numpy(cap["track"]))
    win = convert.window_from_numpy(convert.to_numpy(cap["win"]))
    prev_buf = tfused.to_device(np.array(cap["img_prev"]), "cpu")
    _, r_t, t_t, _, b_t = tfused.tracking_step(
        track, win, prev_buf, tfused.to_device(buf, "cpu"), torch.Generator().manual_seed(5),
        _t(cap["r_cur"]), _t(cap["t_cur"]), _t(cap["r_prev"]), _t(cap["t_prev"]), torch.zeros(3),
        _t(r_bc), _t(r_cb), _t(t_cb), port_cfg(cfg),
    )
    b_t = tfused.unpack_bundle(b_t.numpy())
    assert b_t["success"] == b_j["success"] and b_j["success"]
    assert b_t["is_kf"] == b_j["is_kf"]
    assert abs(b_t["n_inliers"] - b_j["n_inliers"]) <= 3
    assert abs(b_t["n_tracked"] - b_j["n_tracked"]) <= 3
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=5e-3)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=5e-4)


def _check_convert_round_trip(runs):
    jax_est = runs["jax"][0]
    for state, back in ((jax_est.track, convert.track_from_numpy), (jax_est.win, convert.window_from_numpy)):
        arrays = convert.to_numpy(state)
        again = convert.to_numpy(back(arrays))
        assert arrays.keys() == again.keys()
        for k in arrays:
            assert again[k].shape == arrays[k].shape, k
            np.testing.assert_array_equal(again[k], arrays[k].astype(again[k].dtype), err_msg=k)


def _check_end_to_end(runs):
    """Both initialize within +-1 frame, keyframe counts within +-2, and
    the port's sim3 ATE <= max(1.5 x JAX, JAX + 0.01) and < 0.08 x extent
    (tests/test_e2e_vo.py:73)."""
    ts = runs["ts"]
    jax_est, jax_res = runs["jax"]
    torch_est, torch_res = runs["torch"]
    assert torch_est.initialized and jax_est.initialized
    assert abs(_init_frame(torch_res) - _init_frame(jax_res)) <= 1
    n_kf_t = sum(r.is_keyframe for r in torch_res)
    n_kf_j = sum(r.is_keyframe for r in jax_res)
    assert abs(n_kf_t - n_kf_j) <= 2, (n_kf_t, n_kf_j)
    assert int(torch_est.win.n_kf) >= 3  # as tests/test_e2e_vo.py
    ate_t, ate_j = _ate(torch_res, ts), _ate(jax_res, ts)
    i0 = _init_frame(torch_res)
    extent = np.linalg.norm(ts[i0:] - ts[i0:].mean(0), axis=1).max()
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.01), (ate_t, ate_j)
    assert ate_t < 0.08 * extent, (ate_t, extent)
    lost = [r for r in torch_res if r.state == "tracking_lost"]
    assert len(lost) <= len(torch_res) // 3
    ts_, rs_, ps_ = torch_est.export_trajectory()
    assert len(ts_) == N_FRAMES and np.isfinite(ps_).all()
    assert int(torch_est.win.lm_alive.sum()) > 50


def test_vo_slice_matches_jax(runs):
    """One test over the module's single pair of estimator runs: xdist
    hands consecutive tests to different workers, and each worker would
    otherwise repeat both runs."""
    _check_tracking_step(runs)
    _check_convert_round_trip(runs)
    _check_end_to_end(runs)


# ---------------------------------------------------------------------------
# Kernels K1-K4 against their plain versions on a CUDA card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    """Decided here, never at import time, so every xdist worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda:0")


def _f(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _ba_args(dev, k, m=512, seed=0):
    rng = np.random.default_rng(seed)
    pts = _f(rng.uniform(-5, 5, (m, 3)) + np.array([0, 0, 7.0]), dev)
    rs = tlie.so3_exp(_f(rng.uniform(-0.05, 0.05, (k, 3)), dev))
    ts = _f(np.cumsum(rng.uniform(-0.05, 0.08, (k, 3)), 0), dev)
    rcb, tcb = tlie.so3_exp(_f([0.02, -0.01, 0.03], dev)), _f([0.01, 0.0, -0.02], dev)
    p_b = torch.einsum("kji,mj->kmi", rs, pts) - torch.einsum("kji,kj->ki", rs, ts)[:, None]
    uv = tcam.project(torch.einsum("ij,kmj->kmi", rcb, p_b) + tcb, W, H) + _f(rng.standard_normal((k, m, 2)) * 0.5, dev)
    mask = torch.as_tensor(rng.random((k, m)) < 0.7, device=dev).float()
    fixed_pose = torch.zeros(k, dtype=torch.bool, device=dev)
    fixed_pose[0] = True
    fixed_point = torch.as_tensor(rng.random(m) < 0.1, device=dev)
    ts_p = ts + _f(rng.normal(0, 0.03, (k, 3)), dev)
    ts_p[0] = ts[0]
    return (rs, ts_p, pts, uv, mask, fixed_pose, fixed_point, 1e-4, rcb, tcb, W, H, 1.0, 1.0, False)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 6, 10])
def test_ba_iteration_kernel_matches_plain(dev, k):
    """K3 within 2e-3."""
    args = _ba_args(dev, k, seed=k)
    got = ba_cuda.ba_iteration(*args)
    ref = ba_cuda._ba_plain(*args, None)
    for name, g, r in zip(["r", "t", "pts", "cur_cost", "new_cost", "step"], got, ref):
        scale = max(1.0, float(r.abs().max()))
        torch.testing.assert_close(g, r, atol=2e-3 * scale, rtol=2e-3, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 10])
def test_ba_solve_kernel_matches_plain(dev, k):
    """K2: cost within 2%, poses within 5e-3; one launch per solve."""
    args = _ba_args(dev, k, m=2048, seed=10 + k)
    before = ba_cuda.LAUNCHES["lm_ba_solve"]
    got = ba_cuda.ba_solve(*args, max_iterations=50)
    ref = ba_cuda._ba_plain(*args, 50)
    assert ba_cuda.LAUNCHES["lm_ba_solve"] == before + 1
    assert abs(float(got[3]) - float(ref[3])) < 0.02 * float(ref[3])
    assert float((got[0] - ref[0]).abs().max()) < 5e-3 and float((got[1] - ref[1]).abs().max()) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 130, 2048])
@pytest.mark.parametrize("k", [1, 2, 6, 10, 16])
def test_ba_solve_kernel_shapes(dev, k, m):
    """K2 on one cluster at every window size up to 16 and any M: cost
    within 2%, poses within 5e-3. At M = 1 the landmark is seen by every
    keyframe and every pose is fixed (one landmark cannot hold K free
    poses), so only it moves."""
    args = list(_ba_args(dev, k, m=m, seed=100 + k))
    if m == 1:
        args[4] = torch.ones_like(args[4])
        args[5] = torch.ones_like(args[5])
    got = ba_cuda.ba_solve(*args, max_iterations=50)
    ref = ba_cuda._ba_plain(*args, 50)
    assert abs(float(got[3]) - float(ref[3])) <= 0.02 * float(ref[3]) + 1e-6  # a cost of 0 at M = 1
    assert float((got[0] - ref[0]).abs().max()) < 5e-3 and float((got[1] - ref[1]).abs().max()) < 5e-3
    assert bool(torch.isfinite(got[2]).all())


@pytest.mark.cuda
def test_ba_solve_kernel_every_point_fixed(dev):
    """K2 with every landmark fixed: a pose-only problem; the landmarks
    come back bit-equal."""
    args = list(_ba_args(dev, 10, m=2048, seed=7))
    args[6] = torch.ones_like(args[6])
    got = ba_cuda.ba_solve(*args, max_iterations=50)
    ref = ba_cuda._ba_plain(*args, 50)
    assert abs(float(got[3]) - float(ref[3])) < 0.02 * float(ref[3])
    assert float((got[0] - ref[0]).abs().max()) < 5e-3 and float((got[1] - ref[1]).abs().max()) < 5e-3
    assert torch.equal(got[2], args[2])


@pytest.mark.cuda
def test_lm_kernels_are_deterministic(dev):
    """K2 (cluster, rank-ordered reduction) and K1: two calls on the same
    inputs return equal tensors and equal iteration counts."""
    args = _ba_args(dev, 10, m=2048, seed=12)
    a, b = ba_cuda.ba_solve(*args, max_iterations=50), ba_cuda.ba_solve(*args, max_iterations=50)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    rng = np.random.default_rng(3)
    m = 1024
    pts = _f(rng.uniform(-5, 5, (m, 3)) + np.array([0, 0, 7.0]), dev)
    r_cb, t_cb = tlie.so3_exp(_f([0.01, 0.02, -0.01], dev)), _f([0.02, 0.01, 0.0], dev)
    obs = tcam.project((pts - _f([0.15, -0.1, 0.2], dev)) @ r_cb.T + t_cb, W, H)
    obs = obs + _f(rng.standard_normal((m, 2)) * 0.5, dev)
    active = torch.ones(m, dtype=torch.bool, device=dev)
    marg = torch.zeros(m, dtype=torch.bool, device=dev)
    pargs = (torch.eye(3, device=dev), torch.zeros(3, device=dev), pts, obs, active, marg, 1e-4,
             r_cb, t_cb, W, H, 1.0, 1.0, 5.991, 4, 50)
    a, b = ba_cuda._pnp_launch(*pargs), ba_cuda._pnp_launch(*pargs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_ba_launch_raises_when_the_kernel_refuses(dev, monkeypatch):
    """A shape the launcher refuses (K above its 16) raises, not returns."""
    monkeypatch.setattr(ba_cuda, "_MAX_K", 17)
    args = _ba_args(dev, 17, m=128)
    with pytest.raises(RuntimeError):
        ba_cuda._ba_launch(*args, 50)


@pytest.mark.cuda
def test_pnp_kernel_matches_plain(dev):
    """K1: t 5e-3, R 5e-4, inliers +-3; marginalized slots never outliers."""
    rng = np.random.default_rng(9)
    m = 1024
    pts = _f(rng.uniform(-5, 5, (m, 3)) + np.array([0, 0, 7.0]), dev)
    r_true, t_true = tlie.so3_exp(_f([0.03, -0.02, 0.01], dev)), _f([0.15, -0.1, 0.2], dev)
    r_cb, t_cb = tlie.so3_exp(_f([0.01, 0.02, -0.01], dev)), _f([0.02, 0.01, 0.0], dev)
    obs = tcam.project(((pts - t_true) @ r_true) @ r_cb.T + t_cb, W, H) + _f(rng.standard_normal((m, 2)) * 0.5, dev)
    obs[:40] += 40.0
    active = torch.as_tensor(rng.random(m) < 0.9, device=dev)
    marg = torch.as_tensor(rng.random(m) < 0.05, device=dev)
    args = (torch.eye(3, device=dev), torch.zeros(3, device=dev), pts, obs, active, marg, 1e-4, r_cb, t_cb,
            W, H, 1.0, 1.0, 5.991, 4, 50)
    got = ba_cuda.pnp_solve(*args)
    ref = ba_cuda._pnp_plain(*args)
    assert float((got[1] - ref[1]).abs().max()) < 5e-3
    assert float((got[0] - ref[0]).abs().max()) < 5e-4
    assert abs(int(got[4]) - int(ref[4])) <= 3
    assert not bool((got[2] & marg).any())


@pytest.mark.cuda
@pytest.mark.parametrize("num_levels", [3, 2])
def test_lk_kernel_matches_plain(dev, num_levels):
    """K4: < 1e-2 px on features both track, status count >= 0.98x."""
    img0, img1 = (_f(a, dev) for a in _image(0))
    rng = np.random.default_rng(0)
    n = 1024
    uv = _f(np.stack([rng.uniform(0, W, n), rng.uniform(40, H - 40, n)], -1), dev)
    valid = torch.as_tensor(rng.random(n) < 0.95, device=dev)
    args = (img0, img1, uv, valid, None, num_levels, 10, 30, 0.01)
    uk, sk, ek = lk_cuda.track(*args)
    up, sp, ep = lk_cuda.track_plain(*args)
    assert int(sk.sum()) >= 0.98 * int(sp.sum())
    both = sk & sp
    assert float((uk - up)[both].abs().max()) < 1e-2
    assert float((ek - ep)[both].abs().max()) < 1e-4


@pytest.mark.cuda
def test_wrappers_refuse_mixed_devices(dev):
    args = list(_ba_args(dev, 2, m=128))
    args[2] = args[2].cpu()
    with pytest.raises(ValueError):
        ba_cuda.ba_solve(*args)
