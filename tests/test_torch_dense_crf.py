"""The port's Gaussian kernel filter twin and dense-CRF loss against fedicra_tpu's (CPU).

On the CPU, JAX's ``gaussian_kernel_filter`` runs its XLA path
(``_gaussian_filter_xla``), the plain reference of the Pallas kernel, as
tests/test_pallas_kernels.py runs it. Tolerances: against the float64
dense oracle rtol 2e-4 / atol 1e-4, as there; against JAX rtol 1e-5 and
an atol of 1e-5 where signed values make outputs of ~10 from cancelling
terms (the same expanded-form arithmetic, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.losses.dense_crf import dense_crf_loss
from fedicra_torch.ops import gaussian_filter_cuda as gf
from fedicra_tpu.losses.dense_crf import dense_crf_loss as jax_dense_crf_loss
from fedicra_tpu.ops.pallas_kernels import bilateral_features as jax_bilateral_features
from fedicra_tpu.ops.pallas_kernels import gaussian_kernel_filter as jax_gaussian_filter
from torch_port_helpers import t


def _oracle(feats, values):
    f = feats.astype(np.float64)
    d2 = ((f[:, None, :] - f[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2) @ values.astype(np.float64)


@pytest.mark.parametrize("n, d, c", [(300, 5, 3), (257, 3, 1), (120, 4, 2)])
def test_twin_matches_jax_and_dense_oracle(n, d, c):
    rng = np.random.default_rng(n)
    feats = rng.uniform(0, 3, size=(n, d)).astype(np.float32)
    values = rng.normal(size=(n, c)).astype(np.float32)
    got = gf.gaussian_kernel_filter(t(feats), t(values)).numpy()
    np.testing.assert_allclose(got, _oracle(feats, values), rtol=2e-4, atol=1e-4)
    want = np.asarray(jax_gaussian_filter(jnp.asarray(feats), jnp.asarray(values)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # in smaller column chunks: the same up to sum order
    np.testing.assert_allclose(gf.gaussian_filter_plain(t(feats), t(values), tn=64).numpy(), got,
                               rtol=1e-5, atol=1e-5)


def test_twin_vjp_is_the_filtered_cotangent():
    rng = np.random.default_rng(1)
    n, d, c = 120, 4, 2
    feats = rng.uniform(0, 2, size=(n, d)).astype(np.float32)
    values = rng.normal(size=(n, c)).astype(np.float32)
    g = rng.normal(size=(n, c)).astype(np.float32)

    _, vjp = jax.vjp(lambda v: jax_gaussian_filter(jnp.asarray(feats), v), jnp.asarray(values))
    (dv_j,) = vjp(jnp.asarray(g))
    f_t = t(feats).requires_grad_(True)
    v_t = t(values).requires_grad_(True)
    (gf.gaussian_kernel_filter(f_t, v_t) * t(g)).sum().backward()
    np.testing.assert_allclose(v_t.grad.numpy(), np.asarray(dv_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v_t.grad.numpy(), _oracle(feats, g), rtol=2e-4, atol=1e-4)
    assert f_t.grad is None  # no feature gradient, as in the JAX custom VJP


def test_batched_twin_equals_each_image():
    rng = np.random.default_rng(2)
    feats = rng.uniform(0, 3, size=(3, 90, 5)).astype(np.float32)
    values = rng.uniform(size=(3, 90, 3)).astype(np.float32)
    got = gf.gaussian_kernel_filter(t(feats), t(values))
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy(), gf.gaussian_kernel_filter(t(feats[b]), t(values[b])).numpy())


def test_bilateral_features_match_jax():
    img = np.random.default_rng(3).uniform(size=(2, 6, 9, 3)).astype(np.float32)
    got = gf.bilateral_features(t(img), 15.0, 50.0).numpy()
    for b in range(2):
        want = np.asarray(jax_bilateral_features(jnp.asarray(img[b]), 15.0, 50.0))
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("h, w, k", [(16, 16, 2), (18, 14, 3), (20, 12, 3)])
def test_dense_crf_loss_matches_jax(h, w, k):
    """The 2x downsample goes through the antialiased linear resize and the
    nearest-exact resize; odd downscaled sizes (9x7) cover both hazards.
    Value at rtol 1e-5; dL/dlogits (~1e-11 at weight 2e-9) at rtol 1e-4 and
    an atol of 1e-5 of its largest element."""
    rng = np.random.default_rng(h * w)
    images = rng.uniform(size=(2, h, w, 3)).astype(np.float32)
    logits = rng.normal(size=(2, h, w, k)).astype(np.float32)
    rois = (rng.uniform(size=(2, h, w)) < 0.8).astype(np.float32)

    def f_jax(lg):
        return jax_dense_crf_loss(jnp.asarray(images), jax.nn.softmax(lg, -1), jnp.asarray(rois))

    want, grad_j = jax.value_and_grad(f_jax)(jnp.asarray(logits))
    lg = t(logits).requires_grad_(True)
    gf.reset_launches()
    got = dense_crf_loss(t(images), torch.softmax(lg, -1), t(rois))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    np.testing.assert_allclose(lg.grad.numpy(), grad_j, rtol=1e-4, atol=1e-5 * np.abs(grad_j).max())
    assert gf.launches["gaussian_filter"] == 0  # CPU tensors take the twin


def test_consistent_labelling_lowers_the_loss():
    rng = np.random.default_rng(2)
    images = t(rng.uniform(size=(1, 16, 16, 3)).astype(np.float32))
    rois = torch.ones(1, 16, 16)
    uniform = torch.full((1, 16, 16, 2), 0.5)
    onehot = torch.zeros(1, 16, 16, 2)
    onehot[..., 0] = 1.0
    l_u = dense_crf_loss(images, uniform, rois, weight=1.0).item()
    l_o = dense_crf_loss(images, onehot, rois, weight=1.0).item()
    assert np.isfinite(l_u) and np.isfinite(l_o)
    assert l_o < l_u
