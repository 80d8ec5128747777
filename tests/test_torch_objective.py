"""The port's "Ours" objective (tree term off) against fedicra_tpu's (CPU),
and the tree weight's effect on the port's terms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.convert import state_dict_to_flax
from fedicra_torch.engine import objective as port_obj
from fedicra_tpu.engine import objective as jax_obj
from torch_port_helpers import assert_trees_close, batch, configs, models, port_stats, t


def _port_grads(model):
    grads = {
        n: (p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in model.named_parameters()
    }
    grads.update(dict(model.named_buffers()))
    return state_dict_to_flax(grads)[0]


@pytest.fixture(scope="module")
def jax_ours():
    jcfg, _ = configs()
    jm, v, _ = models()

    @jax.jit
    def f(params, stats, images, labels, cid):
        def loss_fn(p):
            return jax_obj.ours_loss(
                jm, p, stats, jax.random.PRNGKey(0),
                {"image": images, "label": labels}, cid, jcfg,
            )

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    return f


@pytest.mark.parametrize("cid", [0, 2])
def test_ours_loss_terms_grads_and_stats_match_jax(jax_ours, cid):
    """Grads at rtol 1e-4, atol 1e-5. The batch seeds are ones where no
    LeakyReLU input lies within the two frameworks' fp32 forward difference
    of the kink: a flip there moves that element's gradient by 0.99 g in
    any pair of fp32 implementations, the port's own float32 and float64
    runs included."""
    _, pcfg = configs()
    _, v, pm = models()
    image, label = batch(seed=cid)
    (loss_j, (stats_j, m_j)), grads_j = jax_ours(
        v["params"], v["batch_stats"], jnp.asarray(image), jnp.asarray(label),
        jnp.asarray(cid, jnp.int32),
    )

    pm.train()
    loss_p, m_p = port_obj.ours_loss(pm, {"image": t(image), "label": t(label)}, cid, pcfg)
    loss_p.backward()

    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5, atol=5e-6)
    for k in ("loss_ce", "loss_crf", "loss_lc", "loss_tree"):
        np.testing.assert_allclose(m_p[k].item(), float(m_j[k]), rtol=1e-5, atol=5e-6, err_msg=k)
    np.testing.assert_array_equal(m_p["vis_pred"].numpy(), np.asarray(m_j["vis_pred"]))
    assert_trees_close(_port_grads(pm), grads_j, rtol=1e-4, atol=1e-5)
    assert_trees_close(port_stats(pm), stats_j, rtol=1e-4, atol=2e-5)


def test_ours_loss_takes_the_tree_term():
    """A nonzero tree weight is taken: the term is positive, linear in the
    weight, and leaves the other terms as they are at 0. Its value against
    JAX is held in tests/test_torch_tree_energy.py."""
    _, _, pm = models()
    image, label = batch()
    pm.eval()  # no running-statistics drift between the three calls
    runs = {}
    for weight in (0.0, 0.1, 0.2):
        _, pcfg = configs(tree_loss_weight=weight)
        with torch.no_grad():
            runs[weight] = port_obj.ours_loss(pm, {"image": t(image), "label": t(label)}, 1, pcfg)[1]
    assert runs[0.0]["loss_tree"].item() == 0.0
    assert runs[0.1]["loss_tree"].item() > 0.0
    np.testing.assert_allclose(runs[0.2]["loss_tree"].item(), 2 * runs[0.1]["loss_tree"].item(), rtol=1e-6)
    for k in ("loss_ce", "loss_crf", "loss_lc"):
        assert runs[0.1][k].item() == runs[0.0][k].item(), k


@pytest.mark.parametrize("cid", [0, 3])
def test_contrast_loss_matches_jax(cid):
    """K sequential train-mode forwards, k == cid skipped, k == 0 under the
    own cid; the running statistics advance once per included forward."""
    jcfg, pcfg = configs()
    jm, v, pm = models()
    image, _ = batch(seed=20 + cid)
    hm_own = np.asarray(
        jm.apply(v, jnp.asarray(image), train=False, emb_idx=jnp.full((2,), cid, jnp.int32))["heatmaps"][-1]
    )
    loss_j, stats_j = jax.jit(
        lambda p, s: jax_obj._contrast_loss(
            jm, p, s, jnp.asarray(image), jnp.asarray(hm_own), jnp.asarray(cid, jnp.int32),
            jax.random.PRNGKey(1), jcfg,
        )
    )(v["params"], v["batch_stats"])

    pm.train()
    loss_p = port_obj._contrast_loss(pm, t(image), t(hm_own), cid, pcfg)
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5, atol=1e-7)
    assert_trees_close(port_stats(pm), stats_j, rtol=1e-4, atol=2e-5)
