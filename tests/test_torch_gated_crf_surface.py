"""The full gated-CRF surface of the port against fedicra_tpu's (CPU).

Several kernels, xy-only kernels, ``mask_src`` and ``mask_dst`` (with NaN
and fractional values, which ``_fix_mask`` zeroes) and a compatibility
matrix: the loss and its gradient to the logits agree with JAX's XLA
streaming loss at rtol 1e-5. The gradient has an absolute floor of 1e-5 of
its largest element: an element is a float32 sum over up to 240 offset and
kernel terms of up to that size, and where they cancel to ~0 its rounding
(~240 x 6e-8 of the largest term) is all that is left. With every argument
at its default, the loss is the kernel's plain twin bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.losses import gated_crf as port_crf
from fedicra_torch.ops.gated_crf_cuda import gated_crf_potts_plain
from fedicra_tpu.losses import gated_crf as jax_crf
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

B, H, W, C = 2, 12, 10, 3
TWO_KERNELS = [{"weight": 0.7, "xy": 4.0, "rgb": 0.2}, {"weight": 0.3, "xy": 2.0}]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    image = (0.5 + 0.3 * np.sin(3 * xx + 2 * yy))[None, ..., None] + 0.05 * rng.normal(size=(B, H, W, 3))
    logits = 2.0 * rng.normal(size=(B, H, W, C))
    return image.astype(np.float32), logits.astype(np.float32), rng


def _mask(rng, kind):
    """A mask with ones, zeros, fractions (zeroed by _fix_mask) and NaNs."""
    m = rng.choice([1.0, 1.0, 0.0, 0.5, 2.0], size=(B, H, W)).astype(np.float32)
    m[0, 0, :3] = np.nan
    return m[..., None] if kind == "4d" else m


def _both(image, logits, **kw):
    """(loss, d loss / d logits) from JAX and from the port."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    pkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    img = jnp.asarray(image)
    j_loss, j_grad = jax.value_and_grad(
        lambda lg: jax_crf.gated_crf_loss(jax.nn.softmax(lg, -1), img, **jkw))(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    p_loss = port_crf.gated_crf_loss(torch.softmax(lg, -1), torch.from_numpy(image), **pkw)
    p_loss.backward()
    return (float(j_loss), np.asarray(j_grad)), (p_loss.item(), lg.grad.numpy())


def _assert_close(jax_out, port_out):
    (jl, jg), (pl, pg) = jax_out, port_out
    assert np.isfinite(pl) and pl != 0.0
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(pg, jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


CASES = {
    "mask_src": lambda rng: {"mask_src": _mask(rng, "3d")},
    "mask_dst": lambda rng: {"mask_dst": _mask(rng, "4d")},
    "mask_src and mask_dst": lambda rng: {"mask_src": _mask(rng, "4d"), "mask_dst": _mask(rng, "3d")},
    "compatibility": lambda rng: {"compatibility": np.array(
        [[0.0, 1.0, 3.0], [2.0, 0.0, 0.5], [1.0, 1.0, 0.0]], np.float32)},
    "two kernels": lambda rng: {"kernels_desc": TWO_KERNELS},
    "xy-only kernel": lambda rng: {"kernels_desc": [{"weight": 1.0, "xy": 3.0}]},
    "everything": lambda rng: {"kernels_desc": TWO_KERNELS, "mask_src": _mask(rng, "3d"),
                               "mask_dst": _mask(rng, "3d"),
                               "compatibility": np.array([[0, 1, 1], [1, 0, 2], [3, 1, 0]], np.float32)},
}


@pytest.mark.parametrize("radius", [2, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_surface_matches_jax(case, radius):
    image, logits, rng = _inputs()
    _assert_close(*_both(image, logits, radius=radius, **CASES[case](rng)))


@pytest.mark.parametrize("radius", [2, 5])
def test_defaults_are_the_twin_bit_for_bit(radius):
    image, logits, _ = _inputs(1)
    probs, img = torch.softmax(torch.from_numpy(logits), -1), torch.from_numpy(image)
    twin = gated_crf_potts_plain(probs.permute(0, 3, 1, 2).contiguous(),
                                 port_crf.gated_crf_features(img, 6.0, 0.1).permute(0, 3, 1, 2).contiguous(),
                                 radius)
    assert torch.equal(port_crf.gated_crf_loss(probs, img, radius=radius), twin)
    # the general path on the live kernel, spelt out, computes the same sums
    general = port_crf.gated_crf_loss(probs, img, radius=radius, kernels_desc=[port_crf.LIVE_KERNEL])
    torch.testing.assert_close(general, twin, rtol=1e-6, atol=0)
    _assert_close(*_both(image, logits, radius=radius))


def test_all_ones_mask_dst_is_the_potts_loss():
    """An all-ones mask_dst gates nothing and keeps B*H*W as denominator;
    an all-ones mask_src would drop the neighbours outside the image."""
    image, logits, _ = _inputs(2)
    probs, img = torch.softmax(torch.from_numpy(logits), -1), torch.from_numpy(image)
    potts = port_crf.gated_crf_loss(probs, img)
    ones = torch.ones(B, H, W)
    torch.testing.assert_close(port_crf.gated_crf_loss(probs, img, mask_dst=ones), potts,
                               rtol=1e-6, atol=0)
    assert port_crf.gated_crf_loss(probs, img, mask_src=ones) < potts


def test_fix_mask_matches_jax():
    _, _, rng = _inputs()
    for kind in ("3d", "4d"):
        m = _mask(rng, kind)
        m[1, 2, 3] = np.inf
        np.testing.assert_array_equal(port_crf._fix_mask(torch.from_numpy(m)).numpy(),
                                      np.asarray(jax_crf._fix_mask(jnp.asarray(m))))


@pytest.mark.parametrize("sigma_rgb", [0.1, None])
def test_features_match_jax(sigma_rgb):
    image, _, _ = _inputs()
    np.testing.assert_array_equal(
        port_crf.gated_crf_features(torch.from_numpy(image), 6.0, sigma_rgb).numpy(),
        np.asarray(jax_crf.gated_crf_features(jnp.asarray(image), 6.0, sigma_rgb)))


@pytest.mark.parametrize("radius", [1, 3])
def test_offsets_are_recomputed_in_the_backward(monkeypatch, radius):
    """The general path keeps no offset's kernel values for the backward
    (torch.utils.checkpoint per offset): the backward forms each offset's
    exps again, as many as the forward did."""
    image, logits, rng = _inputs()
    calls = []
    exp = torch.exp
    monkeypatch.setattr(torch, "exp", lambda x: calls.append(x.shape) or exp(x))
    lg = torch.from_numpy(logits).requires_grad_(True)
    loss = port_crf.gated_crf_loss(torch.softmax(lg, -1), torch.from_numpy(image), radius=radius,
                                   kernels_desc=TWO_KERNELS, mask_dst=torch.from_numpy(_mask(rng, "3d")))
    forward = len(calls)
    loss.backward()
    assert forward == 2 * ((2 * radius + 1) ** 2 - 1) and len(calls) == 2 * forward
