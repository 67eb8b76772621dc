"""The port's loop closure and relocalization against the JAX package.

- Descriptors: ``ring_descriptor``, ``score_all_shifts``,
  ``extract_patches`` (levels 0 and 2, across the ERP seam and at the
  top / bottom rows) and ``match_patches``: 1e-5, with equal indices.
- Retrieval and verification (``_retrieve_and_verify_cam``): one place
  database of rendered 480x240 views given to both packages, the JAX side
  at ``solver.backend = "xla"`` and the port on K1's plain version; full
  and yaw-only loop queries, and a relocalization query with fewer
  queryable entries than ``verify_top_k`` (the top-k ties): equal
  candidate, shift, match count, PnP success and inlier count, and the
  PnP pose within K1's bounds (t 5e-3, R 5e-4).
- State transforms (``apply_world_correction``, ``inject_landmarks``,
  ``transform_db``): 1e-6.
- K1 batched: the plain version over B = 3 equals three B = 1 calls; on
  the card (``cuda``), each problem of a B = 4 launch equals its own
  B = 1 launch bit for bit.
- The ring-wrap self-match guard at ``db_capacity`` 4.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from test_torch_port import port_cfg
    from vio360_tpu import config as cfgmod
    from vio360_tpu.estimator import window as jwin
    from vio360_tpu.loop import closure as jclo, descriptor as jdesc
except ModuleNotFoundError as e:
    # A card's machine may have no JAX: there only ``pytest -m cuda`` is meaningful.
    if e.name != "jax":
        raise
from vio360_tpu_torch import convert, synthetic as tsyn
from vio360_tpu_torch.estimator import window as twin
from vio360_tpu_torch.geometry import camera as tcam, lie as tlie
from vio360_tpu_torch.loop import closure as tclo, descriptor as tdesc
from vio360_tpu_torch.solver import ba_cuda

torch.set_num_threads(1)

W, H = 480, 240
C = 256


def _t(x):
    return torch.as_tensor(np.array(x))


def _jcfg(**loop):
    cfg = cfgmod.VioConfig(
        camera=cfgmod.CameraConfig(width=W, height=H, boundary_margin=10.0),
        features=cfgmod.FeatureConfig(max_features=250, capacity=C),
        solver=cfgmod.SolverConfig(backend="xla"),
        loop=cfgmod.LoopConfig(db_capacity=8, **loop),
    )
    return dataclasses.replace(cfg, loop=cfgmod.fit_loop_config(cfg.loop, cfg.camera))


def _texture(seed, h=H, w=W):
    return tsyn.make_panorama(seed, h, w, octaves=5).numpy()


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------


def test_ring_descriptor_and_scores_match_jax():
    img = _texture(3)
    imgs = [np.roll(img, 8 * k, 1) * (1.0 - 0.1 * k) + 0.05 * k for k in range(4)] + [_texture(4)]
    jd = [jdesc.ring_descriptor(jnp.asarray(x), 16, 60) for x in imgs]
    td = [tdesc.ring_descriptor(_t(x), 16, 60) for x in imgs]
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    js, jsh = jdesc.score_all_shifts(jd[0], jnp.stack(jd))
    ts, tsh = tdesc.score_all_shifts(td[0], torch.stack(td))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))


@pytest.mark.parametrize("levels", [0, 2])
def test_extract_patches_match_jax(levels):
    img = _texture(5)
    rng = np.random.default_rng(6)
    uv = np.concatenate([
        np.stack([rng.uniform(0, W, 40), rng.uniform(0, H, 40)], -1),
        [[0.25, 100.0], [W - 0.5, 120.3], [W - 3.7, 0.2], [2.0, H - 0.6], [240.5, 0.0],
         [100.0, H - 1.0]],
    ]).astype(np.float32)
    valid = np.ones(len(uv), bool)
    valid[3] = False
    jp = jdesc.extract_patches(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(valid), 8, levels)
    tp = tdesc.extract_patches(_t(img), _t(uv), _t(valid), 8, levels)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    assert not tp[3].any()


def test_match_patches_matches_jax():
    img = _texture(7)
    rng = np.random.default_rng(8)
    n = 64
    uv = np.stack([rng.uniform(20, W - 20, n), rng.uniform(40, H - 40, n)], -1).astype(np.float32)
    pq = tdesc.extract_patches(_t(img), _t(uv), torch.ones(n, dtype=torch.bool), 8).numpy()
    perm = rng.permutation(n)
    pc = pq[perm] + rng.standard_normal(pq.shape).astype(np.float32) * 0.05
    vq, vc = rng.random(n) < 0.9, rng.random(n) < 0.9
    for ncc, margin in ((0.6, 0.02), (0.95, 0.1)):
        jm, js = jdesc.match_patches(jnp.asarray(pq), jnp.asarray(vq), jnp.asarray(pc),
                                     jnp.asarray(vc), ncc, margin)
        tm, ts = tdesc.match_patches(_t(pq), _t(vq), _t(pc), _t(vc), ncc, margin)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    assert (tm.numpy() >= 0).sum() > 10


# ---------------------------------------------------------------------------
# Retrieval and verification
# ---------------------------------------------------------------------------

RADIUS = 6.0


def _pose(yaw, t, tilt=(0.0, 0.0)):
    r = tlie.so3_exp(_t(np.float32([tilt[0], tilt[1], yaw]))).numpy()
    return r, np.float32(t)


def _landmarks(r, t, uv):
    """World points where the pixels' rays from (r, t) meet the texture sphere."""
    b_w = tcam.pixel_to_bearing(_t(uv), W, H).numpy() @ r.T
    tb = b_w @ t
    s = -tb + np.sqrt(tb * tb + RADIUS ** 2 - t @ t)
    return (t + s[:, None] * b_w).astype(np.float32)


def _project(r, t, pts):
    uv = tcam.project(_t(((pts - t) @ r).astype(np.float32)), W, H).numpy()
    ok = (uv[:, 1] > 0.2 * H) & (uv[:, 1] < 0.8 * H)
    return uv.astype(np.float32), ok


@pytest.fixture(scope="module")
def place_db():
    """Six rendered views around a circuit as a database (JAX-described,
    the same arrays to both packages), and a query view near entry 2 with
    the features of entry 2's landmarks."""
    jcfg = _jcfg()
    lcfg = jcfg.loop
    pano = tsyn.make_panorama(21, 2 * H, 2 * W, octaves=6)
    render = lambda r, t: tsyn.render_textured_view(pano, _t(r), _t(t), W, H, RADIUS).numpy()
    rng = np.random.default_rng(22)
    gu, gv = np.meshgrid(np.linspace(12, W - 12, 20), np.linspace(0.22 * H, 0.78 * H, 11))
    grid = np.stack([gu.ravel(), gv.ravel()], -1).astype(np.float32)  # 220 features
    db = jclo.empty_db(jcfg)
    entries = []
    for e in range(6):
        r, t = _pose(0.9 * e, [0.6 * np.cos(0.9 * e), 0.6 * np.sin(0.9 * e), 0.05 * e])
        img = render(r, t)
        uv = np.zeros((C, 2), np.float32)
        uv[:len(grid)] = grid + rng.uniform(-3, 3, grid.shape).astype(np.float32)
        valid = np.arange(C) < len(grid)
        pts = np.zeros((C, 3), np.float32)
        pts[valid] = _landmarks(r, t, uv[valid])
        desc = jdesc.ring_descriptor(jnp.asarray(img), lcfg.desc_bands, lcfg.desc_bins)
        patches = jdesc.extract_patches(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(valid),
                                        lcfg.patch_size, lcfg.patch_pyr_levels)
        db = jclo._ingest(db, e, desc, patches, jnp.asarray(uv), jnp.asarray(pts),
                          jnp.asarray(valid), jnp.asarray(r), jnp.asarray(t))
        entries.append((r, t, pts, valid))
    r_q, t_q = _pose(0.9 * 2 + 0.06, [0.6 * np.cos(1.8) + 0.08, 0.6 * np.sin(1.8) - 0.05, 0.12],
                     tilt=(0.02, -0.015))
    uv_q, ok = _project(r_q, t_q, entries[2][2])
    valid_q = entries[2][3] & ok
    uv_q = np.where(valid_q[:, None], uv_q + rng.normal(0, 0.3, uv_q.shape), 0.0).astype(np.float32)
    img_q = render(r_q, t_q)
    desc_q = jdesc.ring_descriptor(jnp.asarray(img_q), lcfg.desc_bands, lcfg.desc_bins)
    patches_q = jdesc.extract_patches(jnp.asarray(img_q), jnp.asarray(uv_q), jnp.asarray(valid_q),
                                      lcfg.patch_size, lcfg.patch_pyr_levels)
    # the odometry's estimate of the query pose: drifted
    r_kf = tlie.so3_exp(_t(np.float32([0.03, -0.02, 0.08]))).numpy() @ r_q
    t_kf = (t_q + np.float32([0.2, -0.1, 0.05])).astype(np.float32)
    query = dict(desc=np.asarray(desc_q), patches=np.asarray(patches_q), uv=uv_q, valid=valid_q,
                 r_kf=r_kf.astype(np.float32), t_kf=t_kf, r_q=r_q, t_q=t_q)
    return jcfg, convert.to_numpy(db), query


@pytest.mark.parametrize("case", ["full", "yaw_only", "reloc_few"])
def test_retrieve_and_verify_matches_jax(place_db, case):
    jcfg, db_np, q = place_db
    cfg = port_cfg(jcfg)
    qmask = np.zeros(jcfg.loop.db_capacity, bool)
    qmask[[1, 2] if case == "reloc_few" else list(range(6))] = True
    seed = case == "reloc_few"
    yaw = case == "yaw_only"
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    r_kf, t_kf = (eye, zero) if seed else (q["r_kf"], q["t_kf"])
    jdb = jclo.LoopDb(**{k: jnp.asarray(v) for k, v in db_np.items()})
    jrec, (jr, jt), jpts, jinj = jclo._retrieve_and_verify_cam(
        jdb, jnp.asarray(q["desc"]), jnp.asarray(q["patches"]), jnp.asarray(q["uv"]),
        jnp.asarray(q["valid"]), jnp.asarray(qmask), jnp.asarray(seed), jnp.asarray(r_kf),
        jnp.asarray(t_kf), jnp.eye(3), jnp.zeros(3), jcfg, yaw_only=yaw)
    trec, (tr, tt), tpts, tinj = tclo.retrieve_and_verify(
        convert.loop_db_from_numpy(db_np), _t(q["desc"]), _t(q["patches"]), _t(q["uv"]),
        _t(q["valid"]), _t(qmask), seed, _t(r_kf), _t(t_kf), torch.eye(3), torch.zeros(3), cfg,
        yaw_only=yaw)
    a, b = jclo.unpack_record(np.asarray(jrec)), tclo.unpack_record(trec.numpy())
    for key in ("cand", "shift", "n_match", "pnp_ok", "n_inliers"):
        assert a[key] == b[key], (key, a[key], b[key])
    assert a["cand"] == 2 and a["pnp_ok"], a
    assert abs(a["score"] - b["score"]) < 1e-5
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=5e-3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=5e-4)
    np.testing.assert_allclose(b["corr_r"], a["corr_r"], atol=5e-4)
    np.testing.assert_allclose(b["corr_t"], a["corr_t"], atol=5e-3)
    np.testing.assert_array_equal(tinj.numpy(), np.asarray(jinj))
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), atol=1e-6)
    # the verified pose is the query's true pose
    assert np.abs(tt.numpy() - q["t_q"]).max() < 0.02
    if yaw:
        np.testing.assert_allclose(b["corr_r"][2], [0, 0, 1], atol=1e-6)


# ---------------------------------------------------------------------------
# State transforms
# ---------------------------------------------------------------------------


def _window_arrays(seed=0, k=4, l=64, c=32):
    rng = np.random.default_rng(seed)
    i32 = np.int32
    kf_id = np.array([3, 8, 12, -1], i32)
    lm_alive = rng.random(l) < 0.6
    lm_feat_id = np.where(lm_alive, rng.permutation(100)[:l], -1).astype(i32)
    return dict(
        kf_r=tlie.so3_exp(_t(rng.normal(0, 0.3, (k, 3)).astype(np.float32))).numpy(),
        kf_t=rng.normal(0, 1, (k, 3)).astype(np.float32),
        kf_vel=rng.normal(0, 1, (k, 3)).astype(np.float32),
        kf_bg=np.zeros((k, 3), np.float32), kf_ba=np.zeros((k, 3), np.float32),
        kf_time=np.arange(k, dtype=np.float32), kf_id=kf_id,
        kf_feat_uv=rng.uniform(0, 100, (k, c, 2)).astype(np.float32),
        kf_feat_id=rng.integers(-1, 100, (k, c)).astype(i32), n_kf=np.asarray(3, i32),
        lm_pos=rng.normal(0, 3, (l, 3)).astype(np.float32), lm_alive=lm_alive,
        lm_marg=lm_alive & (rng.random(l) < 0.3),
        lm_slot=np.where(lm_alive, rng.integers(0, c, l), -1).astype(i32),
        lm_feat_id=lm_feat_id, lm_ref_kf=np.where(lm_alive, 3, -1).astype(i32),
    )


def _assert_windows_equal(tw, jw, atol=1e-6):
    a, b = convert.to_numpy(tw), {k: np.asarray(v) for k, v in convert.to_numpy(jw).items()}
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=k)


def test_state_transforms_match_jax():
    arrays = _window_arrays()
    jw = jwin.WindowState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tw = convert.window_from_numpy(arrays)
    rng = np.random.default_rng(1)
    rc = tlie.so3_exp(_t(np.float32([0.1, -0.2, 0.7]))).numpy()
    tc = np.float32([0.5, -1.0, 2.0])
    poses = [tlie.so3_exp(_t(rng.normal(0, 0.3, 3).astype(np.float32))).numpy()
             if i % 2 == 0 else rng.normal(0, 1, 3).astype(np.float32) for i in range(4)]
    vel = rng.normal(0, 1, 3).astype(np.float32)
    jo = jclo.apply_world_correction(jw, jnp.asarray(rc), jnp.asarray(tc),
                                     *(jnp.asarray(p) for p in poses), jnp.asarray(vel))
    to = tclo.apply_world_correction(tw, _t(rc), _t(tc), *(_t(p) for p in poses), _t(vel))
    _assert_windows_equal(to[0], jo[0])
    for a, b in zip(to[1:], jo[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)

    # inject: some ids already have a landmark, some slots are not ok
    c = 32
    feat_ids = np.where(rng.random(c) < 0.8, rng.permutation(120)[:c], -1).astype(np.int32)
    pos = rng.normal(0, 2, (c, 3)).astype(np.float32)
    ok = (rng.random(c) < 0.7) & (feat_ids >= 0)
    ji = jclo.inject_landmarks(jw, jnp.asarray(pos), jnp.asarray(ok), jnp.asarray(feat_ids),
                               jnp.asarray(12, jnp.int32))
    ti = tclo.inject_landmarks(tw, _t(pos), _t(ok), _t(feat_ids), torch.tensor(12, dtype=torch.int32))
    _assert_windows_equal(ti, ji)
    assert ti.lm_alive.sum() > tw.lm_alive.sum()

    jcfg = _jcfg()
    db_np = {k: np.asarray(v) for k, v in convert.to_numpy(jclo.empty_db(jcfg)).items()}
    db_np["lm_pos"] = rng.normal(0, 3, db_np["lm_pos"].shape).astype(np.float32)
    db_np["pose_t"] = rng.normal(0, 1, db_np["pose_t"].shape).astype(np.float32)
    r_gw, s, anchor = rc.T, 1.7, np.float32([0.3, 0.1, -0.2])
    jd = jclo.transform_db(jclo.LoopDb(**{k: jnp.asarray(v) for k, v in db_np.items()}),
                           jnp.asarray(r_gw), jnp.asarray(s, jnp.float32), jnp.asarray(anchor))
    td = tclo.transform_db(convert.loop_db_from_numpy(db_np), _t(r_gw), s, _t(anchor))
    for k, v in convert.to_numpy(td).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jd, k)), atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# K1 batched, ring wrap
# ---------------------------------------------------------------------------


def _pnp_batch(b, m=256, seed=0, dev="cpu"):
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-4, 4, (b, m, 3)) + np.array([0, 0, 6.0])).astype(np.float32)
    r_true = tlie.so3_exp(_t(rng.normal(0, 0.03, (b, 3)).astype(np.float32))).numpy()
    t_true = rng.normal(0, 0.1, (b, 3)).astype(np.float32)
    p_c = np.einsum("bji,bmj->bmi", r_true, pts - t_true[:, None])
    obs = tcam.project(_t(p_c.astype(np.float32)), 960, 480).numpy()
    obs = obs + rng.standard_normal(obs.shape).astype(np.float32) * 0.5
    obs[:, :20] += 40.0
    active = rng.random((b, m)) < 0.9
    active[-1, 8:] = False  # too few inliers: fails
    marg = rng.random((b, m)) < 0.05
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    return (t(np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))), t(np.zeros((b, 3), np.float32)),
            t(pts), t(obs), t(active), t(marg), 1e-4, torch.eye(3, device=dev),
            torch.zeros(3, device=dev), 960, 480, 1.0, 1.0, 5.991, 4, 50)


def test_batched_pnp_plain_equals_single_calls():
    args = _pnp_batch(3)
    got = ba_cuda.pnp_solve(*args)
    for b in range(3):
        one = ba_cuda.pnp_solve(*(a[b] for a in args[:6]), *args[6:])
        for x, y in zip(got, one):
            assert torch.equal(x[b], y)
    assert int(got[4][0]) > 200 and int(got[4][2]) < 10


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_batched_pnp_kernel_equals_single_launches(dev):
    args = _pnp_batch(4, m=1024, dev=dev)
    before = ba_cuda.PNP_BATCHES[4]
    got = ba_cuda._pnp_launch(*args)
    assert ba_cuda.PNP_BATCHES[4] == before + 1
    for b in range(4):
        one = ba_cuda._pnp_launch(*(a[b] for a in args[:6]), *args[6:])
        for x, y in zip(got, one):
            assert torch.equal(x[b], y)
    ref = ba_cuda._pnp_plain(*args)
    assert float((got[1] - ref[1]).abs().max()) < 5e-3
    assert float((got[0] - ref[0]).abs().max()) < 5e-4


def test_ring_wrap_masks_the_slot_being_overwritten(monkeypatch):
    """db_capacity 4: once the ring wraps, the keyframe's own slot (just
    overwritten with its entry, still mapped to the old frame) is never a
    candidate."""
    cfg = port_cfg(_jcfg(exclude_recent_kf=1, verify_top_k=2))
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, db_capacity=4))
    lc = tclo.LoopCloser(cfg)
    masks = []
    real = tclo.retrieve_and_verify

    def spy(db, desc, patches, uv, valid, qmask, *a, **kw):
        masks.append(qmask.clone())
        return real(db, desc, patches, uv, valid, qmask, *a, **kw)

    monkeypatch.setattr(tclo, "retrieve_and_verify", spy)
    img = _t(_texture(31))
    rng = np.random.default_rng(0)
    uv = _t(np.stack([rng.uniform(20, W - 20, C), rng.uniform(60, H - 60, C)], -1).astype(np.float32))
    valid = torch.arange(C) < 64
    ids = torch.where(valid, torch.arange(C, dtype=torch.int32), torch.full((C,), -1, dtype=torch.int32))
    win = twin.empty_window(4, 64, C)
    hits = []
    for fid in range(6):
        w = lc._write_idx()
        hits.append(lc.on_keyframe(img, uv, ids, valid, win, torch.eye(3), torch.zeros(3),
                                   torch.eye(3), torch.zeros(3), fid * 10, yaw_only=False))
        assert lc.entry_fid[w] == fid * 10
        if masks and len(masks) == fid:  # queried on this keyframe
            assert not bool(masks[-1][w])
    assert len(masks) == 5 and [int(m.sum()) for m in masks] == [1, 2, 3, 3, 3]
    assert all(h is None for h in hits)  # no landmarks: nothing verifies
