"""Ensemble uncertainty of the port against fedicra_tpu's, on JAX's draws (CPU).

Each model is initialised by flax, its output convolution scaled by 40 so
that the ensemble's softmax is far from uniform and the entropy moves with
the input, and carried into the port through the weight bridge. JAX's
draws (its ``k_rot`` / ``k_noise`` split, ``randint`` and ``normal``) are
fed to the port, so both evaluate the same ensemble; the entropies agree
at rtol 1e-5.

JAX rotates every batch by 270 degrees whatever its ``randint`` draws: its
four ``lax.switch`` branches are lambdas of one loop variable, which reads 3
when they are traced (``evaluation/uncertainty.py:28-32``). The port
rotates by the count it draws, as the reference does (flower_common.py:155-188);
fed JAX's draws, it is given the rotation JAX applies, and a ramp model
pins the difference.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.convert import flax_to_state_dict
from fedicra_torch.evaluation import uncertainty as port_unc
from fedicra_torch.models import net_factory as port_net_factory
from fedicra_tpu.evaluation import uncertainty as jax_unc
from fedicra_tpu.models import net_factory
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

T = 8  # the ensemble size, both packages' default
JAX_ROTATION = 3  # the count JAX's switch applies, whatever it draws


@functools.lru_cache(maxsize=None)
def _pair(model_type):
    jm = net_factory(model_type, in_chns=3, class_num=3)
    v = jm.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                jnp.zeros((1, 32, 32, 3)), train=False)
    v = jax.tree.map(np.asarray, dict(v))
    out = v["params"]["decoder"]["out_conv"]["conv"]
    out["kernel"], out["bias"] = out["kernel"] * 40.0, out["bias"] * 40.0
    pm = port_net_factory(model_type, in_chns=3, class_num=3)
    sd = flax_to_state_dict(v["params"], v["batch_stats"])
    names = {n for n, _ in pm.named_parameters()}
    params = {k: x for k, x in sd.items() if k in names}
    stats = {k: x for k, x in sd.items() if k not in names}
    return jm, v, pm, params, stats


def _jax_draws(key, shape, num_samples, rotation=None):
    """JAX's draws inside batch_uncertainty: (its randint's count, (rotation,
    noise)), the noise drawn in the shape of ``rotation`` (by default the
    count JAX applies)."""
    k_rot, k_noise = jax.random.split(key)
    drawn = int(jax.random.randint(k_rot, (), 0, 4))
    rotation = JAX_ROTATION if rotation is None else rotation
    b, h, w, c = shape
    rotated = (b, w, h, c) if rotation % 2 else (b, h, w, c)
    noise = np.stack([np.asarray(jax.random.normal(kk, rotated))
                      for kk in jax.random.split(k_noise, num_samples)])
    return drawn, (rotation, torch.from_numpy(noise))


def _images(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("hw", [(32, 32), (32, 16)], ids=["square", "non-square"])
@pytest.mark.parametrize("model_type", ["unet", "unet_lc_multihead"])
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_batch_uncertainty_on_jax_draws(model_type, hw, seed):
    jm, v, pm, params, stats = _pair(model_type)
    images = _images(seed, (2, *hw, 3))
    key = jax.random.PRNGKey(seed)
    want = float(jax_unc.batch_uncertainty(jm, v["params"], v["batch_stats"], jnp.asarray(images),
                                           key, num_samples=T))
    _, draws = _jax_draws(key, images.shape, T)
    got = port_unc.batch_uncertainty(pm, params, stats, torch.from_numpy(images), draws=draws)
    assert got.shape == () and 0.05 < got.item() < 0.9 * np.log(3)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    assert pm.training  # the model's mode is left as it was


class _JaxRamp(nn.Module):
    """Logits that weigh each row by its index, so a rotation shows."""

    @nn.compact
    def __call__(self, x, train=False):
        return {"logits": x * jnp.arange(x.shape[1], dtype=x.dtype)[None, :, None, None]}


class _PortRamp(torch.nn.Module):
    def forward(self, x):
        return {"logits": x * torch.arange(x.shape[1], dtype=x.dtype)[None, :, None, None]}


def _seed_drawing(count):
    return next(s for s in range(100)
                if int(jax.random.randint(jax.random.split(jax.random.PRNGKey(s))[0], (), 0, 4)) == count)


@pytest.mark.parametrize("count", [0, 1, 2, 3])
def test_jax_rotates_by_270_degrees_whatever_it_draws(count):
    seed = _seed_drawing(count)
    images = _images(seed, (2, 16, 8, 3))
    key = jax.random.PRNGKey(seed)
    want = float(jax_unc.batch_uncertainty(_JaxRamp(), {}, {}, jnp.asarray(images), key, num_samples=T))
    drawn, as_applied = _jax_draws(key, images.shape, T)
    _, as_drawn = _jax_draws(key, images.shape, T, rotation=drawn)
    x = torch.from_numpy(images)
    applied = port_unc.batch_uncertainty(_PortRamp(), {}, {}, x, draws=as_applied).item()
    rotated = port_unc.batch_uncertainty(_PortRamp(), {}, {}, x, draws=as_drawn).item()
    assert drawn == count
    np.testing.assert_allclose(applied, want, rtol=1e-6)
    assert (abs(rotated - want) < 1e-6 * want) == (count == JAX_ROTATION), (rotated, want)


def test_evaluate_uncertainty_over_three_batches(monkeypatch):
    """Three batches, with the draws of JAX's per-batch key splits."""
    jm, v, pm, params, stats = _pair("unet_lc_multihead")
    batches = [_images(10 + i, (2, 32, 32, 3)) for i in range(3)]
    key = jax.random.PRNGKey(7)
    want = jax_unc.evaluate_uncertainty(jm, v["params"], v["batch_stats"], batches, key,
                                        num_samples=T)
    keys = []
    for _ in batches:
        key, k = jax.random.split(key)
        keys.append(k)
    fed = iter(keys)
    monkeypatch.setattr(port_unc, "draw_uncertainty",
                        lambda shape, num_samples, generator: _jax_draws(next(fed), shape, num_samples)[1])
    got = port_unc.evaluate_uncertainty(pm, params, stats, batches, torch.Generator(),
                                        num_samples=T, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_draws_follow_the_generator():
    """Two generators at one seed draw the same; the noise has the rotated
    shape; the rotation counts cover 0-3."""
    shape = (2, 8, 4, 3)
    seen = set()
    for seed in range(12):
        k1, n1 = port_unc.draw_uncertainty(shape, 3, torch.Generator().manual_seed(seed))
        k2, n2 = port_unc.draw_uncertainty(shape, 3, torch.Generator().manual_seed(seed))
        assert k1 == k2 and torch.equal(n1, n2)
        assert n1.shape == ((3, 2, 4, 8, 3) if k1 % 2 else (3, 2, 8, 4, 3))
        seen.add(k1)
    assert seen == {0, 1, 2, 3}
