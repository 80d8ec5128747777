"""The port's permutohedral lattice and lattice dense-CRF loss against
fedicra_tpu's (CPU).

The four cases of ``tests/test_permutohedral.py`` on the port's filter and
loss, with their tolerances: the lattice is an approximation (Adams et al.
2010) whose [1 2 1] blur over-smooths slightly, like the lattice the
reference vendors. Then the port against JAX: the same source built with
the same flags gives the same filter bit for bit, and the lattice loss and
its gradient agree at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.losses.dense_crf import dense_crf_loss, dense_crf_loss_lattice
from fedicra_torch.ops.permutohedral import permutohedral_filter
from fedicra_tpu import native
from fedicra_tpu.losses.dense_crf import dense_crf_loss_lattice as jax_lattice_loss
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)


def _filter(pos, val):
    return permutohedral_filter(torch.from_numpy(pos), torch.from_numpy(val)).numpy()


def _brute(pos, val, sigma=1.0):
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    K = np.exp(-0.5 * d2 / sigma**2)
    return K @ val, K @ np.ones((pos.shape[0], 1))


# ----- tests/test_permutohedral.py -----

@pytest.mark.parametrize("d", [2, 5])
def test_normalized_filter_close_to_gaussian(d):
    rng = np.random.default_rng(0)
    N = 400
    pos = rng.uniform(0, 3, size=(N, d)).astype(np.float32)
    val = rng.normal(size=(N, 4)).astype(np.float32)
    got = _filter(pos, val)
    got_n = got / _filter(pos, np.ones((N, 1), np.float32))
    exact, norm = _brute(pos, val)
    err = np.abs(got_n - exact / norm)
    assert np.median(err) < 0.02, np.median(err)
    assert err.mean() < 0.05, err.mean()


def test_constant_values_preserved():
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 2, size=(200, 3)).astype(np.float32)
    val = np.full((200, 2), 1.7, np.float32)
    got = _filter(pos, val)
    ones = _filter(pos, np.ones((200, 1), np.float32))
    np.testing.assert_allclose(got / ones, 1.7, rtol=1e-4)


def test_batch_matches_single():
    rng = np.random.default_rng(2)
    pos = rng.uniform(0, 2, size=(2, 100, 2)).astype(np.float32)
    val = rng.normal(size=(2, 100, 3)).astype(np.float32)
    batched = _filter(pos, val)
    for b in range(2):
        single = _filter(pos[b], val[b])
        np.testing.assert_allclose(batched[b], single, rtol=1e-5, atol=1e-5)


def _dense_crf_inputs(b=2, h=32, w=32, k=3, seed=3):
    rng = np.random.default_rng(seed)
    # smooth image so the bilateral kernel has structure
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = (np.sin(yy / 7.0) * np.cos(xx / 5.0) * 0.5 + 0.5)[None, ..., None]
    images = np.clip(base + 0.05 * rng.normal(size=(b, h, w, 3)), 0, 1).astype(np.float32)
    logits = rng.normal(size=(b, h, w, k)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    rois = (rng.uniform(size=(b, h, w)) > 0.3).astype(np.float32)
    return images, probs, rois


def test_dense_crf_lattice_vs_exact():
    """The lattice loss tracks the exact evaluation (the Gaussian filter's
    twin here): sign and order of magnitude (the raw lattice filter carries
    a scale bias at d=5, as the reference's vendored lattice does), and the
    gradient's direction."""
    images, probs, rois = _dense_crf_inputs()
    b, h, w, k = probs.shape
    t = torch.from_numpy
    exact = dense_crf_loss(t(images), t(probs), t(rois)).item()
    approx, d_probs = dense_crf_loss_lattice(t(images), t(probs), t(rois))
    d_probs = d_probs.numpy()
    assert isinstance(approx, float) and np.isfinite(approx) and np.isfinite(d_probs).all()
    assert exact < 0 and approx < 0
    assert 0.3 < approx / exact < 1.7, (approx, exact)

    # d/dprobs_s of -w/b * s^T K s  =  -2w/b * roi * (K s),  s = probs_s*roi
    oh = ow = h // 2
    img_s = images[:, ::2, ::2] * 255.0
    probs_s = np.asarray(jax.image.resize(jnp.asarray(probs), (b, oh, ow, k), method="linear"))
    rois_s = rois[:, ::2, ::2]
    yy2, xx2 = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    xy = np.stack([xx2, yy2], -1) / 50.0  # sigma_xy * scale_factor
    g_exact = np.zeros((b, oh, ow, k))
    for i in range(b):
        f = np.concatenate([np.broadcast_to(xy, (oh, ow, 2)), img_s[i] / 15.0], -1).reshape(-1, 5)
        K = np.exp(-0.5 * ((f[:, None] - f[None, :]) ** 2).sum(-1))
        s = (probs_s[i] * rois_s[i][..., None]).reshape(-1, k)
        g_exact[i] = ((-2.0 * 2e-9 / b) * rois_s[i].reshape(-1, 1) * (K @ s)).reshape(oh, ow, k)
    cos = np.sum(g_exact * d_probs) / (np.linalg.norm(g_exact) * np.linalg.norm(d_probs) + 1e-30)
    assert cos > 0.9, cos


# ----- against fedicra_tpu -----

@pytest.mark.parametrize("shape", [(300, 2, 4), (2, 150, 5, 3), (3, 64, 3, 1)],
                         ids=["single", "batch-d5", "batch-d3"])
def test_filter_equals_jax_bit_for_bit(shape):
    rng = np.random.default_rng(4)
    *lead, d, c = shape
    pos = rng.uniform(0, 3, size=(*lead, d)).astype(np.float32)
    val = rng.normal(size=(*lead, c)).astype(np.float32)
    got = _filter(pos, val)
    want = native.permutohedral_filter(pos, val)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(32, 32), (30, 22)], ids=["square", "odd-size"])
def test_lattice_loss_matches_jax(hw):
    images, probs, rois = _dense_crf_inputs(h=hw[0], w=hw[1], seed=5)
    want_loss, want_grad = jax_lattice_loss(images, probs, rois)
    t = torch.from_numpy
    loss, grad = dense_crf_loss_lattice(t(images), t(probs), t(rois))
    assert grad.shape == want_grad.shape == (2, hw[0] // 2, hw[1] // 2, 3)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=1e-5,
                               atol=1e-5 * np.abs(want_grad).max())


def test_filter_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="leading"):
        permutohedral_filter(torch.zeros(2, 10, 3), torch.zeros(2, 9, 1))
    with pytest.raises(ValueError, match="expected"):
        permutohedral_filter(torch.zeros(10, 3), torch.zeros(2, 10, 1))
