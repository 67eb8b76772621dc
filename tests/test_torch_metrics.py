"""The port's trajectory metrics and evaluator against the JAX package's.

``vio360_tpu_torch.utils.metrics`` (Umeyama alignment, ATE, RPE and
``evaluate_tum``) against ``vio360_tpu.utils.metrics`` and
``tools/evaluate_ate.py`` on the same seeded trajectories, for each
alignment (sim3, se3, none), to 1e-9; ``io.trajectory.write_kitti``
against the JAX package's text.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from vio360_tpu.io import trajectory as jtio
from vio360_tpu.utils import metrics as jmetrics
from vio360_tpu_torch.io import trajectory as ttio
from vio360_tpu_torch.utils import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIGNS = ("sim3", "se3", "none")


def _rot(phi):
    th = np.linalg.norm(phi)
    k = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _trajectories(seed=3, n=60):
    """Ground truth and an estimate that is a noisy similarity transform of it."""
    rng = np.random.default_rng(seed)
    p_gt = np.cumsum(rng.normal(0, 0.1, (n, 3)), 0)
    r_gt = np.stack([_rot(rng.normal(0, 0.5, 3)) for _ in range(n)])
    r_off = _rot(np.array([0.2, -0.1, 0.4]))
    p_est = 0.7 * p_gt @ r_off.T + np.array([0.3, -1.0, 2.0]) + rng.normal(0, 0.02, (n, 3))
    r_est = np.einsum("ij,njk->nik", r_off, r_gt)
    return r_gt, p_gt, r_est, p_est


@pytest.mark.parametrize("align", ALIGNS)
def test_ate_and_umeyama_match_jax(align):
    _, p_gt, _, p_est = _trajectories()
    got, ref = tmetrics.ate(p_est, p_gt, align), jmetrics.ate(p_est, p_gt, align)
    for f in ("rmse", "mean", "median", "max", "scale"):
        assert abs(getattr(got, f) - getattr(ref, f)) <= 1e-9, f
    assert got.n == ref.n
    for g, r in zip(tmetrics.umeyama_alignment(p_est, p_gt, align == "sim3"),
                    jmetrics.umeyama_alignment(p_est, p_gt, align == "sim3")):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-9)


def test_rpe_matches_jax():
    r_gt, p_gt, r_est, p_est = _trajectories(seed=4)
    for delta in (1, 5):
        got = tmetrics.rpe(r_est, p_est, r_gt, p_gt, delta)
        ref = jmetrics.rpe(r_est, p_est, r_gt, p_gt, delta)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


def _evaluate_ate_tool():
    spec = importlib.util.spec_from_file_location("evaluate_ate_tool",
                                                  os.path.join(REPO, "tools", "evaluate_ate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("align", ALIGNS)
def test_evaluator_matches_the_repo_tool(tmp_path, capsys, align):
    """The same association (nearest ground-truth stamp within 0.02 s: some
    estimates fall outside it) and the same record as tools/evaluate_ate.py."""
    r_gt, p_gt, r_est, p_est = _trajectories(seed=5)
    n = len(p_gt)
    t_gt = np.arange(n) * 0.1
    t_est = t_gt + np.random.default_rng(6).uniform(-0.03, 0.03, n)
    est, gt = str(tmp_path / "est.tum"), str(tmp_path / "gt.tum")
    jtio.write_tum(est, t_est, r_est, p_est)
    jtio.write_tum(gt, t_gt, r_gt, p_gt)
    assert _evaluate_ate_tool().main([est, gt, "--align", align]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tmetrics.evaluate_tum(est, gt, align)
    assert got.keys() == ref.keys()
    assert 3 <= got["n"] < n and got["n"] == ref["n"] and got["align"] == align
    for k, v in ref.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= 1e-9, k
    jtio.write_tum(est, t_est[:2] + 5.0, r_est[:2], p_est[:2])  # nothing associates
    assert "error" in tmetrics.evaluate_tum(est, gt, align)


def test_write_kitti_matches_jax(tmp_path):
    r, _, _, p = _trajectories(seed=7, n=12)
    ttio.write_kitti(str(tmp_path / "t.txt"), r, p)
    jtio.write_kitti(str(tmp_path / "j.txt"), r, p)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
