"""The port's UNetLCMultiHead against fedicra_tpu's, on the same weights (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.convert import flax_to_state_dict, state_dict_to_flax
from torch_port_helpers import assert_trees_close, batch, flat, models, port_stats, t

ATOL = 2e-5


@pytest.mark.parametrize("cid", [0, 3])
def test_train_mode_outputs_and_running_stats(cid):
    jm, v, pm = models()
    image, _ = batch(seed=cid)
    out_j, mut = jm.apply(
        v, jnp.asarray(image), train=True, emb_idx=jnp.full((2,), cid, jnp.int32),
        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"],
    )
    pm.train()
    with torch.no_grad():
        out_p = pm(t(image), emb_idx=torch.full((2,), cid))
    np.testing.assert_allclose(out_p["logits"].numpy(), out_j["logits"], atol=ATOL, rtol=0)
    for a_p, a_j in zip(out_p["aux"], out_j["aux"]):
        np.testing.assert_allclose(a_p.numpy(), a_j, atol=ATOL, rtol=0)
    assert len(out_p["aux"]) == 3
    np.testing.assert_allclose(
        out_p["heatmaps"][-1].numpy(), out_j["heatmaps"][-1], atol=ATOL, rtol=0
    )
    assert out_p["heatmaps"][:-1] == [None] * 4
    assert_trees_close(port_stats(pm), mut["batch_stats"], atol=ATOL, rtol=0)


def test_eval_mode_logits_after_stats_moved():
    jm, v, pm = models()
    image, _ = batch(seed=5)
    # one train forward first, so eval runs on non-trivial running stats
    _, mut = jm.apply(
        v, jnp.asarray(image), train=True, emb_idx=jnp.full((2,), 1, jnp.int32),
        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"],
    )
    pm.train()
    with torch.no_grad():
        pm(t(image), emb_idx=torch.full((2,), 1))
    v2 = {"params": v["params"], "batch_stats": mut["batch_stats"]}
    out_j = jm.apply(v2, jnp.asarray(image), train=False, emb_idx=jnp.full((2,), 2, jnp.int32))
    pm.eval()
    with torch.no_grad():
        out_p = pm(t(image), emb_idx=torch.full((2,), 2))
    np.testing.assert_allclose(out_p["logits"].numpy(), out_j["logits"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("emb_idx", [None, 0])
def test_emb_idx_falsy_falls_back_to_own_client(emb_idx):
    """PARITY #2: Python None or 0 means the encoder's own client id."""
    own = 3
    jm, v, pm = models(client_id=own)
    image, _ = batch(seed=7)
    pm.eval()
    with torch.no_grad():
        got = pm(t(image), emb_idx=emb_idx)["heatmaps"][-1]
        own_hm = pm(t(image), emb_idx=own)["heatmaps"][-1]
        zero_tensor = pm(t(image), emb_idx=torch.zeros(2, dtype=torch.long))["heatmaps"][-1]
    torch.testing.assert_close(got, own_hm, rtol=0, atol=0)
    assert not torch.allclose(got, zero_tensor)  # a tensor 0 is honoured as client 0
    want = jm.apply(v, jnp.asarray(image), train=False, emb_idx=emb_idx)["heatmaps"][-1]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_bridge_round_trips_jax_params():
    _, v, pm = models()
    params, stats = state_dict_to_flax(pm.state_dict())
    for got, want in ((params, v["params"]), (stats, v["batch_stats"])):
        g, w = dict(flat(got)), dict(flat(want))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(k))
    sd = flax_to_state_dict(params, stats)
    assert sd.keys() == pm.state_dict().keys()
