"""One FedICRA round of the port against fedicra_tpu's, from the same weights (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.convert import state_dict_to_flax
from fedicra_torch.engine.trainer import ClientState, init_client_state, make_round_fn
from fedicra_tpu.engine.trainer import ClientState as JaxState
from fedicra_tpu.engine.trainer import make_round_fn as jax_make_round_fn
from torch_port_helpers import assert_trees_close, batch, configs, flat, models

ITERS, REP = 3, 1
# A short schedule, so poly_lr differs by a quarter from the round's first
# step to its last and a wrong step offset shows in the weights.
MAX_ITERATIONS = 6


def _batches():
    parts = [batch(seed=s) for s in (0, 2, 3)]
    return (
        np.stack([p[0] for p in parts]),
        np.stack([p[1] for p in parts]),
    )


@pytest.fixture(scope="module")
def rounds():
    jcfg, pcfg = configs(iters=ITERS, rep_iters=REP, max_iterations=MAX_ITERATIONS)
    jm, v, pm = models()
    images, labels = _batches()
    cid = 1

    jstate = JaxState(
        params=v["params"], batch_stats=v["batch_stats"],
        current_iter=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
    )
    jround = jax.jit(jax_make_round_fn(jm, jcfg))
    jnew, jmetrics = jround(
        jstate, {"image": jnp.asarray(images), "label": jnp.asarray(labels)},
        jnp.asarray(cid, jnp.int32),
    )

    names = {n for n, _ in pm.named_parameters()}
    sd = pm.state_dict()
    state = ClientState(
        params={n: v.clone() for n, v in sd.items() if n in names},
        batch_stats={n: v.clone() for n, v in sd.items() if n not in names},
        current_iter=0, generator=torch.Generator().manual_seed(0),
    )
    snapshots = []
    round_fn = make_round_fn(pm, pcfg, device="cpu")
    new, metrics = round_fn(
        state, {"image": images, "label": labels}, cid,
        on_step=lambda j, m: snapshots.append(
            {n: p.detach().clone() for n, p in pm.named_parameters()}
        ),
    )
    return dict(jnew=jnew, jmetrics=jmetrics, state=state, new=new,
                metrics=metrics, snapshots=snapshots)


def test_round_losses_match_jax(rounds):
    got = rounds["metrics"]["total_loss"].numpy()
    want = np.asarray(rounds["jmetrics"]["total_loss"])
    assert got.shape == want.shape == (ITERS,)
    # step 1: identical weights, no optimizer history -> near-exact
    np.testing.assert_allclose(got[0], want[0], atol=5e-5, rtol=0)
    # later steps: statistical, under Adam's +-lr sign noise
    assert np.abs(got - want).max() < 0.08
    assert np.abs(got - want).mean() < 0.02
    np.testing.assert_allclose(
        rounds["metrics"]["lr"].numpy(), np.asarray(rounds["jmetrics"]["lr"]), rtol=1e-6
    )
    assert rounds["new"].current_iter == int(rounds["jnew"].current_iter) == ITERS


def test_round_params_match_jax(rounds):
    """The weights after both phases, so the body step's update is held too.

    Adam moves each weight by about lr per step whatever its gradient's size,
    so where a gradient is rounding noise its sign, and the step, may differ:
    a few elements per tensor, and every bias of a conv that a BatchNorm
    follows (its gradient is zero in exact arithmetic). The median element
    must still agree to 1e-6, far below the lr * weight-decay term (~7e-5 of
    a weight) and the quarter by which poly_lr falls over the round.
    """
    before, got = (
        dict(flat(state_dict_to_flax({**s.params, **s.batch_stats})[0]))
        for s in (rounds["state"], rounds["new"])
    )
    want = dict(flat(jax.tree.map(np.asarray, rounds["jnew"].params)))
    assert got.keys() == want.keys() == before.keys()
    adam_envelope = 2 * float(np.sum(rounds["jmetrics"]["lr"]))
    for k in want:
        d = np.abs(got[k] - want[k])
        assert d.max() <= adam_envelope, "/".join(k)
        if k[-3:] != ("conv", "conv", "bias"):
            assert np.median(d) <= 1e-6, ("/".join(k), np.median(d))
    moved = [k for k in want if not np.array_equal(before[k], want[k])]
    assert any(k[0] == "encoder" for k in moved)  # the body phase ran


def test_round_batch_stats_match_jax(rounds):
    stats = state_dict_to_flax(rounds["new"].batch_stats)[1]
    assert_trees_close(stats, jax.tree.map(np.asarray, rounds["jnew"].batch_stats), rtol=1e-4, atol=1e-6)


def test_pcs_and_dsn_heads_stay_bit_identical(rounds):
    before, after = rounds["state"].params, rounds["new"].params
    frozen = [n for n in before if ".pcs" in n or ".dsn_head" in n]
    assert frozen
    for n in frozen:
        assert torch.equal(before[n], after[n]), n


def test_head_phase_moves_only_out_conv(rounds):
    before = rounds["state"].params
    head_steps = rounds["snapshots"][: ITERS - REP]
    for snap in head_steps:
        moved = {n for n in before if not torch.equal(before[n], snap[n])}
        assert moved == {"decoder.out_conv.weight", "decoder.out_conv.bias"}
    after = rounds["snapshots"][-1]
    # the body phase leaves out_conv where the head phase put it
    for n in ("decoder.out_conv.weight", "decoder.out_conv.bias"):
        assert torch.equal(head_steps[-1][n], after[n])
    assert not torch.equal(before["encoder.in_conv.conv1.conv.weight"],
                           after["encoder.in_conv.conv1.conv.weight"])


def test_init_client_state_is_seeded():
    _, pcfg = configs()
    _, _, pm = models()
    a = init_client_state(pm, pcfg, seed=3, device="cpu")
    b = init_client_state(pm, pcfg, seed=3, device="cpu")
    c = init_client_state(pm, pcfg, seed=4, device="cpu")
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n])
    assert not torch.equal(a.params["decoder.out_conv.weight"], c.params["decoder.out_conv.weight"])
    assert torch.equal(a.batch_stats["encoder.in_conv.conv1.norm.running_var"], torch.ones(16))
