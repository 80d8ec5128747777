"""The port's partial losses and gated CRF against fedicra_tpu's (CPU).

The gated CRF twin is held against both JAX paths: the XLA offset-streaming
loss and the Pallas kernel run in interpret mode, as
tests/test_gated_crf_pallas.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.losses import gated_crf as port_crf
from fedicra_torch.losses.partial import partial_cross_entropy, partial_dice_loss
from fedicra_torch.ops import gated_crf_cuda
from fedicra_tpu.losses import partial as jax_partial
from fedicra_tpu.losses.gated_crf import gated_crf_loss as jax_crf_xla
from fedicra_tpu.ops.gated_crf_pallas import gated_crf_loss_pallas as jax_crf_pallas
from torch_port_helpers import t

JAX_CRF = {"xla": jax_crf_xla, "pallas": jax_crf_pallas}


def _logits_labels(seed, b=2, h=16, w=16, c=3, all_ignored=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, h, w, c)).astype(np.float32)
    labels = rng.integers(0, c + 1, size=(b, h, w)).astype(np.int32)
    if all_ignored:
        labels[:] = c
    return logits, labels


@pytest.mark.parametrize("all_ignored", [False, True])
def test_partial_cross_entropy_matches_jax(all_ignored):
    logits, labels = _logits_labels(0, all_ignored=all_ignored)
    want = jax_partial.partial_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 3)
    got = partial_cross_entropy(t(logits), t(labels), 3)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


def test_partial_dice_matches_jax():
    logits, labels = _logits_labels(1)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want = jax_partial.partial_dice_loss(probs, jnp.asarray(labels), 3)
    got = partial_dice_loss(t(np.asarray(probs)), t(labels), 3)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


def _crf_data(seed, b=2, h=16, w=16):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    image = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    return logits, image


@pytest.mark.parametrize("path", ["xla", "pallas"])
@pytest.mark.parametrize("radius", [2, 5])
def test_gated_crf_value_matches_jax(path, radius):
    logits, image = _crf_data(radius)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want = float(JAX_CRF[path](probs, jnp.asarray(image), radius=radius))
    got = port_crf.gated_crf_loss(t(np.asarray(probs)), t(image), radius=radius)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


@pytest.mark.parametrize("path", ["xla", "pallas"])
@pytest.mark.parametrize("radius", [2, 5])
def test_gated_crf_grad_through_softmax_matches_jax(path, radius):
    """dL/dlogits through softmax, over a 12x12 image so that every pixel at
    radius 5 is within reach of the border (zero-padded y and features)."""
    logits, image = _crf_data(10 + radius, h=12, w=12)

    def f_jax(lg):
        return JAX_CRF[path](jax.nn.softmax(lg, -1), jnp.asarray(image), radius=radius)

    want = np.asarray(jax.grad(f_jax)(jnp.asarray(logits)))
    lg = t(logits).requires_grad_(True)
    port_crf.gated_crf_loss(torch.softmax(lg, -1), t(image), radius=radius).backward()
    np.testing.assert_allclose(lg.grad.numpy(), want, rtol=1e-4, atol=1e-6)


def test_border_neighbours_are_counted_not_skipped():
    """A uniform one-class map has <y(q), y(q+o)> = 1 inside the image, so the
    whole loss comes from neighbours outside it: k = exp(-|f(q)|^2 / 2) with
    the zero-padded features, times (1 - 0)."""
    b, h, w, r = 1, 6, 7, 2
    probs = np.zeros((b, h, w, 3), np.float32)
    probs[..., 0] = 1.0
    image = np.random.default_rng(3).uniform(size=(b, h, w, 3)).astype(np.float32)
    feats = port_crf.gated_crf_features(t(image), 6.0, 0.1)[0].numpy()
    want = 0.0
    for y in range(h):
        for x in range(w):
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    if not (0 <= y + dy < h and 0 <= x + dx < w):
                        want += np.exp(-0.5 * np.sum(feats[y, x] ** 2, dtype=np.float64))
    got = port_crf.gated_crf_loss(t(probs), t(image), radius=r).item()
    np.testing.assert_allclose(got, want / (b * h * w), rtol=1e-5)
    assert got > 0.0


def test_cuda_wrapper_takes_plain_path_on_cpu_and_counts_nothing():
    logits, image = _crf_data(4)
    probs = torch.softmax(t(logits), -1)
    gated_crf_cuda.reset_launches()
    lg = t(logits).requires_grad_(True)
    got = port_crf.gated_crf_loss_auto(torch.softmax(lg, -1), t(image), radius=3)
    got.backward()
    want = port_crf.gated_crf_loss(probs, t(image), radius=3)
    assert got.item() == want.item()
    assert lg.grad is not None and torch.isfinite(lg.grad).all()
    assert gated_crf_cuda.launches == {"gated_crf": 0}
