"""The per-feature LK kernel K4's arithmetic, on the CPU.

K4 (``vio360_tpu_torch/csrc/lk_pyr.cu``) reads no gradient images: per
level it stages the integer neighbourhood of the previous image, forms
the template and its Scharr gradients at the integer positions and
interpolates every window pixel with the centre's one fractional offset.
``lk_cuda.template_staged`` does the same in plain PyTorch; here it is
held against ``bilinear_sample`` of the image and of its
``scharr_gradients`` (1e-5; the only difference is the rounding of
u + du in the per-pixel sampling) on positions at the ERP seam and in
the top and bottom two rows, where the vertical clamp matters. Also: the
wrapper's batched pyramid equals ``build_pyramid`` of each image bit for
bit, and the port's LK agrees with the Pallas kernel
``vio360_tpu.ops.lk_pallas.track`` run by its interpreter, with the
bounds of tests/test_lk_pallas.py. The ``cuda`` tests hold the kernel
against its plain version on a card (two launches equal, every window
size instantiation, features at the seam); they skip without one.
Seconds on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from vio360_tpu.ops import lk_pallas
except ModuleNotFoundError as e:
    # A card's machine may have no JAX: there only ``pytest -m cuda`` is meaningful.
    if e.name != "jax":
        raise
from vio360_tpu_torch.ops import lk, lk_cuda, pyramid, sampling

torch.set_num_threads(1)


def _positions(h, w, n, seed):
    """Centres with u within 2 px of 0, within 2 px of w, or anywhere, and v
    in the top two rows, the bottom two rows, or anywhere."""
    rng = np.random.default_rng(seed)
    q = n // 4
    u = np.concatenate([rng.uniform(0, 2, q), rng.uniform(w - 2, w, q), rng.uniform(0, w, n - 2 * q)])
    kind = np.arange(n) % 3
    v = np.where(kind == 0, rng.uniform(0, 2, n),
                 np.where(kind == 1, rng.uniform(h - 3, h - 1, n), rng.uniform(0, h - 1, n)))
    return torch.as_tensor(np.stack([u, v], -1), dtype=torch.float32)


def _shifted_pair(h=240, w=480, dx=1, dy=2, seed=0):
    """tests/test_lk_pallas.py's pair: the second image is the first shifted."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.random((h + 8, w + 8)).astype(np.float32), 2.0)
    return base[:h, :w], base[dy:dy + h, dx:dx + w]


@pytest.mark.parametrize("half", [10, 15, 3, 1])
def test_template_staged_matches_sampled_gradients(half):
    """Template, Scharr x and Scharr y the kernel's way = bilinear samples
    of the image and its gradient images, to 1e-5."""
    rng = np.random.default_rng(half)
    h, w = 48, 96
    img = torch.as_tensor(rng.random((h, w)), dtype=torch.float32)
    uv = _positions(h, w, 64, seed=half)
    coords = sampling.patch_coords(uv, half)
    gx, gy = pyramid.scharr_gradients(img)
    got = lk_cuda.template_staged(img, uv, half)
    for name, a, ref_img in zip(("template", "gx", "gy"), got, (img, gx, gy)):
        ref = sampling.bilinear_sample(ref_img, coords)
        assert a.shape == ref.shape == (64, (2 * half + 1) ** 2)
        assert float((a - ref).abs().max()) < 1e-5, name


@pytest.mark.parametrize("num_levels", [3, 5])
def test_prepare_builds_both_pyramids_in_one_pass(num_levels):
    """The wrapper's [2, H, W] pass = build_pyramid of each image, bit for
    bit, at the offsets of its level table (odd sizes included)."""
    rng = np.random.default_rng(1)
    h, w = 61, 118
    a, b = (torch.as_tensor(rng.random((h, w)), dtype=torch.float32) for _ in range(2))
    uv = torch.zeros(4, 2)
    prep = lk_cuda.prepare(a, b, uv, torch.ones(4, dtype=torch.bool), None, num_levels)
    assert prep.meta.n_levels == num_levels + 1
    for lvl, (la, lb) in enumerate(zip(pyramid.build_pyramid(a, num_levels),
                                       pyramid.build_pyramid(b, num_levels))):
        lh, lw, off = prep.meta.h[lvl], prep.meta.w[lvl], prep.meta.offset[lvl]
        assert (lh, lw) == tuple(la.shape)
        assert torch.equal(prep.pyr[off:off + lh * lw].view(lh, lw), la)
        assert torch.equal(prep.pyr[off + lh * lw:off + 2 * lh * lw].view(lh, lw), lb)
    assert prep.pyr.numel() == prep.meta.offset[num_levels] + 2 * lh * lw


def test_port_lk_matches_pallas_interpret():
    """The port's LK on the CPU against lk_pallas.track(interpret=True), with
    tests/test_lk_pallas.py's bounds: status >= 0.9x, < 1e-2 px on features
    both track, and the recovered flow is the shift."""
    img0, img1 = _shifted_pair()
    h, w = img0.shape
    rng = np.random.default_rng(3)
    n = 128
    uv = np.stack([rng.uniform(30, w - 30, n), rng.uniform(40, h - 40, n)], -1).astype(np.float32)
    valid = np.ones(n, bool)
    uv_p, st_p, _ = lk_pallas.track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(uv),
                                    jnp.asarray(valid), interpret=True)
    t = torch.as_tensor
    uv_t, st_t, _ = lk.track(t(img0), t(img1), t(uv), t(valid))
    uv_p, st_p, st_t = np.asarray(uv_p), np.asarray(st_p), st_t.numpy()
    assert st_t.sum() >= 0.9 * st_p.sum() and st_p.sum() >= 0.9 * st_t.sum()
    both = st_p & st_t
    assert np.abs(uv_t.numpy() - uv_p)[both].max() < 1e-2
    flow = np.median(uv_t.numpy()[both] - uv[both], axis=0)
    np.testing.assert_allclose(flow, [-1.0, -2.0], atol=0.1)


@pytest.fixture
def dev():
    """Decided here, never at import time, so every xdist worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda:0")


def _card_problem(dev, n, seam=False):
    img0, img1 = (torch.as_tensor(x, device=dev) for x in _shifted_pair(seed=5))
    h, w = img0.shape
    rng = np.random.default_rng(7)
    u = rng.uniform(0, 2, n) if seam else rng.uniform(0, w, n)
    if seam:
        u[n // 2:] = rng.uniform(w - 2, w, n - n // 2)
    uv = torch.as_tensor(np.stack([u, rng.uniform(30, h - 30, n)], -1), dtype=torch.float32,
                         device=dev)
    valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
    return img0, img1, uv, valid


@pytest.mark.cuda
def test_lk_kernel_is_deterministic_and_counts_its_work(dev):
    """Two launches on the same inputs return equal tensors and work
    counts; invalid features form no template and take no step."""
    img0, img1, uv, valid = _card_problem(dev, 512)
    prep = lk_cuda.prepare(img0, img1, uv, valid, None, 3)
    runs = []
    for _ in range(2):
        work = torch.full((512, 3), -1, dtype=torch.int32, device=dev)
        runs.append((*lk_cuda.launch(prep, 10, 30, 0.01, work=work), work))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    steps, templates, reloads = runs[0][3].unbind(1)
    assert bool((runs[0][3][~valid] == 0).all())
    assert bool((templates[valid] >= 1).all()) and bool((templates <= 4).all())
    assert bool((steps <= 4 * 30).all()) and int(steps.sum()) > 0
    assert bool((reloads <= steps).all()) and bool((reloads >= (steps > 0).int()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("half,num_levels", [(5, 3), (7, 3), (15, 2), (10, 5)])
def test_lk_kernel_window_sizes_match_plain(dev, half, num_levels):
    """Window sizes of 1, 2, 8 and 4 pixels a thread, and levels
    narrower than the staged box (10, 5: the top level is 8 x 15):
    < 1e-2 px on features both track, status count >= 0.98x. Half-width 1
    is left out: LK on a 3x3 window is chaotic on this pair, and there the
    plain version on the card and the same plain version on the CPU already
    end far apart on a few features."""
    img0, img1, uv, valid = _card_problem(dev, 256)
    args = (img0, img1, uv, valid, None, num_levels, half, 30, 0.01)
    uk, sk, ek = lk_cuda.track(*args)
    up, sp, ep = lk_cuda.track_plain(*args)
    assert int(sk.sum()) >= 0.98 * int(sp.sum())
    both = sk & sp
    assert float((uk - up)[both].abs().max()) < 1e-2
    assert float((ek - ep)[both].abs().max()) < 1e-4


@pytest.mark.cuda
def test_lk_kernel_at_the_seam_matches_plain(dev):
    """Features within 2 px of u = 0 and u = W: the staged box wraps."""
    img0, img1, uv, valid = _card_problem(dev, 256, seam=True)
    args = (img0, img1, uv, valid, None, 3, 10, 30, 0.01)
    uk, sk, _ = lk_cuda.track(*args)
    up, sp, _ = lk_cuda.track_plain(*args)
    assert int(sk.sum()) >= 0.98 * int(sp.sum())
    both = sk & sp
    d = (uk - up).abs()
    d[:, 0] = torch.minimum(d[:, 0], img0.shape[1] - d[:, 0])  # u is wrapped into [0, W)
    assert float(d[both].max()) < 1e-2
