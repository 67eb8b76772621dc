"""The port's matmul-gather LK (``vio360_tpu_torch.ops.lk_matmul``) and its
window-gather kernel K5 (``ops/gather_cuda.py``) against the JAX package.

On the CPU:

- K5's plain version against ``gather_pallas.gather_window_pairs(...,
  interpret=True)``, element-exact, at the cases of
  tests/test_gather_pallas.py (edge rows included);
- the port's ``lk_matmul.track`` against the JAX ``lk_matmul.track`` on the
  textured pair of tests/test_lk_matmul.py, with and without a guess:
  <= 1e-3 px on features both keep, status counts within 1%;
- the same run against the port's per-feature ``track_plain`` at the same
  8-step budget, with the 0.05 px max / 0.01 px mean contract of
  tests/test_lk_matmul.py;
- the ``ops.lk`` dispatcher's ``matmul`` route.

On a card (marked ``cuda``): K5 against its plain version, element-exact,
at the main path's shapes, and ``lk_matmul.track`` on the card against the
same call on the CPU.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from vio360_tpu.ops import gather_pallas as jgp, lk_matmul as jlkm
except ModuleNotFoundError as e:
    # A card's machine may have no JAX: there only ``pytest -m cuda`` is meaningful.
    if e.name != "jax":
        raise
from vio360_tpu_torch import device as device_mod
from vio360_tpu_torch.ops import gather_cuda, lk, lk_cuda, lk_matmul

torch.set_num_threads(1)


def _textured_pair(h=240, w=480, dx=1.3, dy=2.1, seed=7):
    """tests/test_lk_matmul.py::_textured_pair: a sum of 24 sinusoids,
    the second image shifted by (dx, dy)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.random.default_rng(seed)

    def tex(ddx, ddy):
        img = np.zeros((h, w), np.float32)
        rr = np.random.default_rng(seed + 1)
        for _ in range(24):
            fx, fy = rr.uniform(0.02, 0.3, 2)
            ph = rr.uniform(0, 2 * np.pi)
            img += np.sin(fx * (xx + ddx) + fy * (yy + ddy) + ph)
        img -= img.min()
        return img / img.max()

    return tex(0.0, 0.0), tex(dx, dy), r


def _lk_inputs(with_guess, n=256):
    img0, img1, rng = _textured_pair()
    h, w = img0.shape
    uv = np.stack([rng.uniform(2, w - 2, n), rng.uniform(30, h - 30, n)], -1).astype(np.float32)
    guess = None
    if with_guess:
        guess = (uv + np.array([-1.3, -2.1]) + rng.uniform(-1.0, 1.0, (n, 2))).astype(np.float32)
    return img0, img1, uv, np.ones(n, bool), guess


def _window_case(g, n, seed=7):
    rng = np.random.default_rng(seed)
    h, wp = 480, 1152
    img = rng.random((h, wp)).astype(np.float32)
    v0 = rng.integers(-6, h + 4, n).astype(np.int32)  # incl. edge clamps
    b = rng.integers(0, wp // 128 - 1, n).astype(np.int32)
    return img, v0, b


@pytest.mark.parametrize("g,n", [(34, 100), (24, 37)])
def test_gather_plain_matches_pallas_interpret(g, n):
    img, v0, b = _window_case(g, n)
    ref = np.asarray(jgp.gather_window_pairs(jnp.asarray(img), jnp.asarray(v0), jnp.asarray(b), g,
                                             interpret=True)).astype(np.float32)
    got = gather_cuda.gather_window_pairs(torch.as_tensor(img), torch.as_tensor(v0),
                                          torch.as_tensor(b), g)
    assert got.dtype == torch.bfloat16 and got.shape == (n, g, 256)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def _run_port(img0, img1, uv, valid, guess, device="cpu"):
    t = lambda a: None if a is None else torch.as_tensor(a, device=device)
    return lk_matmul.track(t(img0), t(img1), t(uv), t(valid), t(guess))


@pytest.mark.parametrize("with_guess", [False, True])
def test_lk_matmul_matches_jax(with_guess):
    """<= 1e-3 px on features both keep; status counts within 1%."""
    img0, img1, uv, valid, guess = _lk_inputs(with_guess)
    uj, sj, ej = jlkm.track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(uv),
                            jnp.asarray(valid), None if guess is None else jnp.asarray(guess))
    ut, st, et = _run_port(img0, img1, uv, valid, guess)
    sj, st = np.asarray(sj), st.numpy()
    assert abs(int(st.sum()) - int(sj.sum())) <= 0.01 * sj.sum() and sj.sum() > 0.9 * len(uv)
    both = sj & st
    assert np.abs(ut.numpy() - np.asarray(uj))[both].max() <= 1e-3
    np.testing.assert_allclose(et.numpy()[both], np.asarray(ej)[both], atol=1e-5)
    # failed features stay at their previous position
    np.testing.assert_array_equal(ut.numpy()[~st], uv[~st])


@pytest.mark.parametrize("with_guess", [False, True])
def test_lk_matmul_matches_per_feature_plain(with_guess):
    """The tests/test_lk_matmul.py contract against the per-feature LK at
    the same 8-step budget: max 0.05 px, mean 0.01 px; the recovered flow
    is the synthetic shift."""
    img0, img1, uv, valid, guess = _lk_inputs(with_guess)
    ut, st, _ = _run_port(img0, img1, uv, valid, guess)
    t = torch.as_tensor
    up, sp, _ = lk_cuda.track_plain(t(img0), t(img1), t(uv), t(valid),
                                    None if guess is None else t(guess), 3, 10, 8, 0.01)
    st, sp = st.numpy(), sp.numpy()
    assert st.sum() >= 0.9 * sp.sum()
    both = st & sp
    d = np.linalg.norm(ut.numpy() - up.numpy(), axis=-1)[both]
    assert d.max() < 0.05 and d.mean() < 0.01, (d.max(), d.mean())
    np.testing.assert_allclose(np.median(ut.numpy()[both] - uv[both], 0), [-1.3, -2.1], atol=0.1)


def test_lk_dispatcher_routes_matmul():
    img0, img1, uv, valid, _ = _lk_inputs(False, n=64)
    t = torch.as_tensor
    a = lk.track(t(img0), t(img1), t(uv), t(valid), iters=30, backend="matmul")
    b = lk_matmul.track(t(img0), t(img1), t(uv), t(valid), iters=8)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="backend"):
        lk.track(t(img0), t(img1), t(uv), t(valid), backend="bogus")


# ---------------------------------------------------------------------------
# On a CUDA card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    """Decided here, never at import time, so every xdist worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    device_mod.pin_fp32()
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("g,wp", [(24, 1152), (34, 1152), (28, 640), (24, 256)])
def test_gather_kernel_matches_plain(dev, g, wp):
    """K5 element-exact at N = 1024 with edge rows; one launch per call."""
    rng = np.random.default_rng(g + wp)
    h = {1152: 480, 640: 240, 256: 60}[wp]
    n = 1024
    img = torch.as_tensor(rng.random((h, wp)).astype(np.float32), device=dev)
    v0 = torch.as_tensor(rng.integers(-6, h + 4, n).astype(np.int32), device=dev)
    b = torch.as_tensor(rng.integers(0, wp // 128 - 1, n).astype(np.int32), device=dev)
    before = gather_cuda.LAUNCHES["gather_win"]
    got = gather_cuda.gather_window_pairs(img, v0, b, g)
    assert gather_cuda.LAUNCHES["gather_win"] == before + 1
    assert torch.equal(got, gather_cuda.gather_window_pairs_plain(img, v0, b, g))


@pytest.mark.cuda
def test_lk_matmul_card_matches_cpu(dev):
    """The same call on the card and on the CPU: within 1e-2 px on
    features both keep (the level images are rounded to bf16, so an f32
    rounding difference in the pyramid matmuls can flip a bf16 value),
    status counts within 1%."""
    img0, img1, uv, valid, guess = _lk_inputs(True, n=1024)
    uc, sc, _ = _run_port(img0, img1, uv, valid, guess, dev)
    up, sp, _ = _run_port(img0, img1, uv, valid, guess)
    sc, sp = sc.cpu(), sp
    assert abs(int(sc.sum()) - int(sp.sum())) <= 0.01 * int(sp.sum())
    both = sc & sp
    assert float((uc.cpu() - up)[both].abs().max()) < 1e-2
