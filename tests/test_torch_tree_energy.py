"""The port's tree energy losses and tree-on objective against fedicra_tpu's (CPU).

The same numpy inputs go through both packages. Where both build the same
trees, loss values are held at rtol 1e-5 and gradients at rtol 1e-4 /
atol 1e-6: the chain of four filters runs the same arithmetic in another
order. Bilinear upsampling makes exact ties in the high trees' MST weights
(neighbour differences are equal along each interpolation segment), and
each framework's fp32 rounding breaks them its own way, so aux logits
upsampled 4x select a few different edges (ROADMAP "Faults"). The loss
tests therefore hold full-resolution guides tightly and upsampled ones
at the stated looser tolerance; the objective and round tests keep the
model's upsampling and their usual tolerances, which the weight-0.1 term
stays inside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.convert import state_dict_to_flax
from fedicra_torch.engine import objective as port_obj
from fedicra_torch.engine import trainer as port_trainer
from fedicra_torch.engine.trainer import ClientState, make_round_fn
from fedicra_torch.losses import tree_energy as port_te
from fedicra_tpu.engine import objective as jax_obj
from fedicra_tpu.engine import trainer as jax_trainer
from fedicra_tpu.engine.trainer import ClientState as JaxState
from fedicra_tpu.engine.trainer import make_round_fn as jax_make_round_fn
from fedicra_tpu.losses import tree_energy as jax_te
from torch_port_helpers import assert_trees_close, batch, configs, flat, models, t

TREE_WEIGHT = 0.1


@pytest.mark.parametrize("src, dst", [((8, 8), (32, 32)), ((12, 6), (24, 24)), ((16, 16), (8, 8)), ((9, 14), (4, 6))])
def test_resizes_match_jax(src, dst):
    """Upsampling and antialiased downsampling; nearest as torch's nearest-exact."""
    x = np.random.default_rng(0).normal(size=(2, *src, 3)).astype(np.float32)
    for method, fn in (("linear", port_te.resize_linear), ("nearest", port_te.resize_nearest)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), method=method))
        got = fn(t(x), dst).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=method)


def _loss_inputs(seed, b=2, h=24, w=24, c=3, aux_scales=(1, 1, 1)):
    rng = np.random.default_rng(seed)
    preds = rng.normal(size=(b, h, w, c)).astype(np.float32)
    image = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    aux = [rng.normal(size=(b, h // s, w // s, c)).astype(np.float32) for s in aux_scales]
    rois = (rng.uniform(size=(b, h, w)) < 0.7).astype(np.float32)
    return preds, image, aux, rois


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("aux_scales", [(1, 1, 1), (4, 2, 1)])
@pytest.mark.parametrize("recursive", [True, False])
def test_multi_scale_tree_energy_matches_jax(recursive, aux_scales):
    """Full-resolution guides: value, AS_k and gradients tightly. Guides
    upsampled 4x and 2x, as the model's aux heads are: the value at rtol 1e-3,
    the differing tie-breaks of a few MST edges included."""
    preds, image, aux, rois = _loss_inputs(seed=1 + recursive, aux_scales=aux_scales)

    def f_jax(p, a1, a2, a3):
        out = jax_te.multi_scale_tree_energy_loss(
            p, jnp.asarray(image), a1, a2, a3, jnp.asarray(rois), TREE_WEIGHT,
            recursive=recursive, host_offload=False,
        )
        return out[0], out[1:]

    (loss_j, as_j), grads_j = jax.value_and_grad(f_jax, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (preds, *aux)))

    leaves = [t(a).requires_grad_(True) for a in (preds, *aux)]
    loss, *as_p = port_te.multi_scale_tree_energy_loss(
        leaves[0], t(image), *leaves[1:], t(rois), TREE_WEIGHT, recursive=recursive)
    loss.backward()
    if aux_scales != (1, 1, 1):
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-3)
        return
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for got, want in zip(as_p, as_j):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    _assert_grads_close([x.grad.numpy() for x in leaves], grads_j)
    assert all(x.grad.abs().max() > 0 for x in leaves)


@pytest.mark.parametrize("with_high", [False, True])
def test_single_scale_tree_energy_matches_jax(with_high):
    preds, image, aux, rois = _loss_inputs(seed=5, h=16, w=16)
    high = aux[1] if with_high else None

    def f_jax(p, hf):
        return jax_te.tree_energy_loss(
            p, jnp.asarray(image), hf, jnp.asarray(rois), TREE_WEIGHT, host_offload=False)[0]

    args = (jnp.asarray(preds), None if high is None else jnp.asarray(high))
    argnums = (0, 1) if with_high else (0,)
    loss_j, grads_j = jax.value_and_grad(f_jax, argnums=argnums)(*args)

    leaves = [t(preds).requires_grad_(True)] + ([t(high).requires_grad_(True)] if with_high else [])
    loss, _ = port_te.tree_energy_loss(
        leaves[0], t(image), leaves[1] if with_high else None, t(rois), TREE_WEIGHT)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    _assert_grads_close([x.grad.numpy() for x in leaves], grads_j)


def test_empty_roi_gives_the_unnormalised_zero():
    preds, image, aux, rois = _loss_inputs(seed=3, h=16, w=16)
    loss, *_ = port_te.multi_scale_tree_energy_loss(
        t(preds), t(image), *(t(a) for a in aux), t(np.zeros_like(rois)), TREE_WEIGHT)
    assert loss.item() == 0.0


def _port_grads(model):
    grads = {
        n: (p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in model.named_parameters()
    }
    grads.update(dict(model.named_buffers()))
    return state_dict_to_flax(grads)[0]


@pytest.mark.parametrize("procedure", ["ours", "treeenergy_add"])
def test_tree_on_objective_matches_jax(procedure):
    """The first step from identical weights, near-exact: every term, every
    gradient (the DSN heads' included) and the running statistics."""
    cid = 2
    jcfg, pcfg = configs(tree_loss_weight=TREE_WEIGHT, procedure=procedure)
    jm, v, pm = models()
    image, label = batch(seed=cid)
    objective = jax_obj.get_objective(jcfg)

    def loss_fn(p):
        return objective(
            jm, p, v["batch_stats"], jax.random.PRNGKey(0),
            {"image": jnp.asarray(image), "label": jnp.asarray(label)},
            jnp.asarray(cid, jnp.int32), jcfg,
        )

    (loss_j, (stats_j, m_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])

    pm.train()
    loss_p, m_p = port_obj.get_objective(pcfg)(pm, {"image": t(image), "label": t(label)}, cid, pcfg)
    loss_p.backward()

    assert m_p.keys() <= m_j.keys()
    assert m_p["loss_tree"].item() > 0.0
    for k in m_p:
        if k != "vis_pred":
            np.testing.assert_allclose(m_p[k].item(), float(m_j[k]), rtol=1e-5, atol=5e-6, err_msg=k)
    grads_p = _port_grads(pm)
    assert_trees_close(grads_p, grads_j, rtol=1e-4, atol=1e-5)
    dsn = grads_p["decoder"]["dsn_head1"]["out_kernel"]
    np.testing.assert_allclose(
        dsn, np.asarray(grads_j["decoder"]["dsn_head1"]["out_kernel"]), rtol=1e-4, atol=1e-6)
    assert np.abs(dsn).max() > 0  # the tree term reaches the DSN heads
    assert_trees_close(state_dict_to_flax(pm.state_dict())[1], stats_j, rtol=1e-4, atol=2e-5)


ITERS, REP, MAX_ITERATIONS = 3, 1, 6


def _start_states(v, pm):
    """The JAX and port client states of one set of weights, at iteration 0."""
    jstate = JaxState(params=v["params"], batch_stats=v["batch_stats"],
                      current_iter=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    names = {n for n, _ in pm.named_parameters()}
    sd = pm.state_dict()
    state = ClientState(
        params={n: x.clone() for n, x in sd.items() if n in names},
        batch_stats={n: x.clone() for n, x in sd.items() if n not in names},
        current_iter=0, generator=torch.Generator().manual_seed(0),
    )
    return jstate, state


@pytest.fixture(scope="module")
def tree_rounds():
    """One 3-step round (2 head, 1 body) at tree weight 0.1 in both packages."""
    jcfg, pcfg = configs(iters=ITERS, rep_iters=REP, max_iterations=MAX_ITERATIONS,
                         tree_loss_weight=TREE_WEIGHT)
    jm, v, pm = models()
    parts = [batch(seed=s) for s in (0, 2, 3)]
    images, labels = np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts])
    cid = 1

    jstate, state = _start_states(v, pm)
    jnew, jmetrics = jax.jit(jax_make_round_fn(jm, jcfg))(
        jstate, {"image": jnp.asarray(images), "label": jnp.asarray(labels)},
        jnp.asarray(cid, jnp.int32))
    snapshots = []
    new, metrics = make_round_fn(pm, pcfg, device="cpu")(
        state, {"image": images, "label": labels}, cid,
        on_step=lambda j, m: snapshots.append({n: p.detach().clone() for n, p in pm.named_parameters()}),
    )
    return dict(jnew=jnew, jmetrics=jmetrics, state=state, new=new, metrics=metrics, snapshots=snapshots)


def test_tree_on_round_matches_jax(tree_rounds):
    """Step 1 near-exact, later steps statistical under Adam's sign noise;
    final weights as in tests/test_torch_trainer.py."""
    r = tree_rounds
    for k in ("total_loss", "loss_tree"):
        got, want = r["metrics"][k].numpy(), np.asarray(r["jmetrics"][k])
        assert got.shape == want.shape == (ITERS,)
        np.testing.assert_allclose(got[0], want[0], atol=5e-5, rtol=0, err_msg=k)
        assert np.abs(got - want).max() < 0.08, k
        assert np.abs(got - want).mean() < 0.02, k
    assert (r["metrics"]["loss_tree"].numpy() > 0).all()

    got = dict(flat(state_dict_to_flax({**r["new"].params, **r["new"].batch_stats})[0]))
    want = dict(flat(jax.tree.map(np.asarray, r["jnew"].params)))
    adam_envelope = 2 * float(np.sum(r["jmetrics"]["lr"]))
    for k in want:
        d = np.abs(got[k] - want[k])
        assert d.max() <= adam_envelope, "/".join(k)
        # The DSN heads take their gradient from the tree term alone, where
        # the upsampled guides' tie-breaks differ; Adam turns those small
        # gradient differences into steps of up to lr, so they are held to
        # the envelope only here. Their update itself, on gradients equal in
        # both packages, is held in test_tree_on_round_updates_dsn_heads_as_jax.
        if k[-3:] != ("conv", "conv", "bias") and not k[1].startswith("dsn_head"):
            assert np.median(d) <= 1e-6, ("/".join(k), np.median(d))


def test_tree_on_round_moves_dsn_heads_only_in_the_body_phase(tree_rounds):
    r = tree_rounds
    before, after = r["state"].params, r["new"].params
    head_end = r["snapshots"][ITERS - REP - 1]
    dsn = [n for n in before if ".dsn_head" in n]
    assert dsn
    for n in before:
        if ".pcs" in n:
            assert torch.equal(before[n], after[n]), n
    for n in dsn:
        assert torch.equal(before[n], head_end[n]), n
    assert all(not torch.equal(before[n], after[n]) for n in dsn if n.endswith("weight"))
    jbefore = dict(flat(state_dict_to_flax({**before, **r["state"].batch_stats})[0]))
    jafter = dict(flat(jax.tree.map(np.asarray, r["jnew"].params)))
    assert any(not np.array_equal(jbefore[k], jafter[k]) for k in jafter if k[1].startswith("dsn_head"))


def test_tree_on_round_updates_dsn_heads_as_jax(monkeypatch):
    """A 3-step round (1 head, 2 body) at tree weight 0.1 in both packages on
    one stand-in objective, sum(exp(p)) over every parameter: its gradient
    exp(p) is the same in both to rounding and far above Adam's eps, so the
    phases' parameter groups, LR schedule and weight decay alone set the
    final weights. Every weight, the DSN heads' included, is held to JAX's
    at atol 5e-7 (the two AdamW implementations differ by up to 1.5 ulp of
    a weight near 1), far below one step's weight decay, 1e-4 |w| at lr
    1e-2, on all but the smallest weights."""

    def jax_get_objective(cfg):
        def objective(model, params, batch_stats, rng, batch, cid, cfg):
            loss = sum(jnp.sum(jnp.exp(p)) for p in jax.tree.leaves(params))
            return loss, (batch_stats, {"total_loss": loss})
        return objective

    def port_get_objective(cfg):
        def objective(model, batch, cid, cfg, generator=None):
            loss = sum(torch.exp(p).sum() for p in model.parameters())
            return loss, {"total_loss": loss}
        return objective

    monkeypatch.setattr(jax_trainer, "get_objective", jax_get_objective)
    monkeypatch.setattr(port_trainer, "get_objective", port_get_objective)
    jcfg, pcfg = configs(iters=3, rep_iters=2, max_iterations=MAX_ITERATIONS,
                         tree_loss_weight=TREE_WEIGHT)
    jm, v, pm = models()
    images, labels = (np.stack([a] * 3) for a in batch())
    jstate, state = _start_states(v, pm)
    jnew, _ = jax.jit(jax_make_round_fn(jm, jcfg))(
        jstate, {"image": jnp.asarray(images), "label": jnp.asarray(labels)},
        jnp.asarray(1, jnp.int32))
    new, _ = make_round_fn(pm, pcfg, device="cpu")(state, {"image": images, "label": labels}, 1)

    before, got = (dict(flat(state_dict_to_flax({**s.params, **s.batch_stats})[0])) for s in (state, new))
    want = dict(flat(jax.tree.map(np.asarray, jnew.params)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-7, err_msg="/".join(k))
    dsn = [k for k in want if k[1].startswith("dsn_head")]
    assert dsn and all(not np.array_equal(before[k], want[k]) for k in dsn)
