"""FedICRA "ours" at the FAZ and the Polyp configuration, the port against
fedicra_tpu (CPU).

The other parity tests build ODOC (3 channels, 3 classes, 5 clients). Here
each case takes a task's own table: FAZ has 1-channel images, 2 classes
and 5 clients, so the gated CRF's features are F = 3 and the tree term's
guide is the gray image; Polyp has 3 channels, 2 classes and 4 clients, so
the PCS embedding and the contrast run over K = 4. In both the unlabelled
index is 2. At 32^2, batch 2, each case holds:

- the ``unet_lc_multihead`` forward in train mode and its running
  statistics from converted flax weights (atol 5e-5 + rtol 5e-5, the
  train-mode class of tests/test_torch_model_family.py);
- ``ours_loss`` with the tree term off and on, its terms (rtol 1e-5 / atol
  5e-6), gradients (rtol 1e-4 / atol 1e-5) and statistics, at the cids of
  tests/test_torch_objective.py;
- the gated CRF through the port's route (its plain twin on CPU tensors)
  against JAX's Pallas kernel in interpret mode (value rtol 1e-5, gradient
  rtol 1e-4 / atol 1e-6);
- the tree chain with the task's image as the guide (FAZ: 1 channel) by
  ``host_offload=True`` on CPU tensors against JAX's ``host_offload=True``,
  at tests/test_tree_host.py's tolerances;
- two federated rounds of FedICRA "ours" (tree weight 0) in both packages,
  at tests/test_torch_federation_rounds.py's tolerances for the losses and
  the aggregates, the evaluation held on JAX's weights at 1e-6.

The batch seeds are ones where no LeakyReLU input lies within the two
frameworks' fp32 difference of the kink, as in tests/test_torch_objective.py.
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedicra_torch.federation.experiment as port_exp
import fedicra_tpu.federation.experiment as jax_exp
from fedicra_torch.convert import flax_to_state_dict, state_dict_to_flax
from fedicra_torch.data.batcher import EpochBatcher
from fedicra_torch.engine import objective as port_obj
from fedicra_torch.engine.config import TASKS as PORT_TASKS
from fedicra_torch.engine.config import TrainConfig as PortConfig
from fedicra_torch.engine.trainer import ClientState, poly_lr
from fedicra_torch.evaluation import evaluate_client
from fedicra_torch.losses import gated_crf as port_crf
from fedicra_torch.losses import tree_energy as port_te
from fedicra_torch.models import net_factory as port_net_factory
from fedicra_torch.ops import tree_filter, tree_filter_cuda
from fedicra_tpu import native
from fedicra_tpu.data.batcher import EpochBatcher as JaxBatcher
from fedicra_tpu.engine import TrainConfig
from fedicra_tpu.engine.config import TASKS as JAX_TASKS
from fedicra_tpu.engine import objective as jax_obj
from fedicra_tpu.losses import tree_energy as jax_te
from fedicra_tpu.models import net_factory
from fedicra_tpu.ops.gated_crf_pallas import gated_crf_loss_pallas
from test_torch_federation_rounds import _record_aggregates, _record_losses
from torch_port_helpers import NO_DROPOUT, assert_trees_close, one_torch_thread, t  # noqa: F401

TASKS = ("faz", "polyp")
IMG, BATCH = 32, 2
TREE_WEIGHT = 0.1


def task_configs(task, **kw):
    """(JAX cfg, port cfg) of FedICRA "ours" for ``task`` at 32^2, batch 2."""
    base = dict(img_size=IMG, batch_size=BATCH, strategy="FedICRA", procedure="ours",
                model="unet_lc_multihead", tree_loss_weight=0.0)
    base.update(kw)
    return TrainConfig.for_task(task, **base), PortConfig.for_task(task, **base)


def _model_kwargs(task):
    table = PORT_TASKS[task]
    return dict(in_chns=table["in_chns"], class_num=table["num_classes"],
                num_clients=len(table["sup_types"]), client_id=0, dropout=NO_DROPOUT,
                dsn_dropout=0.0)


@lru_cache(maxsize=None)
def _flax_init(task):
    """(jax_model, numpy variables) of ``task``'s shape, flax's init from
    seed 0: made once a task (an eager flax init costs ~0.5 s)."""
    jm = net_factory("unet_lc_multihead", **_model_kwargs(task))
    variables = jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, IMG, IMG, PORT_TASKS[task]["in_chns"])), train=False,
    )
    return jm, jax.tree.map(np.asarray, dict(variables))


def task_models(task):
    """(jax_model, jax_variables, port_model) of ``task``'s shape, holding
    the same weights (flax's init, through the weight bridge); the port's
    model is new on every call."""
    jm, variables = _flax_init(task)
    pm = port_net_factory("unet_lc_multihead", **_model_kwargs(task))
    pm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]))
    return jm, variables, pm


def task_batch(task, seed=0, b=BATCH, img_size=IMG):
    """Standardised images of the task's channels and sparse labels (70%
    at the unlabelled index, the task's class count)."""
    table = PORT_TASKS[task]
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(b, img_size, img_size, table["in_chns"])).astype(np.float32)
    label = rng.integers(0, table["num_classes"], size=(b, img_size, img_size))
    label = np.where(rng.uniform(size=label.shape) < 0.7, table["num_classes"], label).astype(np.int32)
    return image, label


def _port_grads(model):
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    grads.update(dict(model.named_buffers()))
    return state_dict_to_flax(grads)[0]


@pytest.mark.parametrize("task", TASKS)
def test_task_tables_match_jax(task):
    """The shapes every other case relies on: FAZ 1 channel, 2 classes, 5
    clients; Polyp 3 channels, 2 classes, 4 clients; the same supervision
    types in both packages."""
    jcfg, pcfg = task_configs(task)
    want = {"faz": (1, 2, 5), "polyp": (3, 2, 4)}[task]
    assert (pcfg.in_chns, pcfg.num_classes, pcfg.num_clients) == want
    assert (jcfg.in_chns, jcfg.num_classes, jcfg.num_clients) == want
    assert PORT_TASKS[task] == JAX_TASKS[task]


@pytest.mark.parametrize("task", TASKS)
def test_train_mode_forward_and_statistics_match_jax(task):
    """Every output of a train-mode forward under a foreign client's
    embedding (the last one, K - 1) and the running statistics it leaves."""
    jm, v, pm = task_models(task)
    _, pcfg = task_configs(task)
    cid = pcfg.num_clients - 1
    image, _ = task_batch(task, seed=3)
    out_j, mut = jm.apply(
        v, jnp.asarray(image), train=True, emb_idx=jnp.full((BATCH,), cid, jnp.int32),
        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    pm.train()
    with torch.no_grad():
        out_p = pm(t(image), emb_idx=torch.full((BATCH,), cid))
    tol = dict(atol=5e-5, rtol=5e-5)
    assert out_p["logits"].shape == (BATCH, IMG, IMG, pcfg.num_classes)
    np.testing.assert_allclose(out_p["logits"].numpy(), out_j["logits"], **tol)
    assert len(out_p["aux"]) == len(out_j["aux"]) == 3
    for a_p, a_j in zip(out_p["aux"], out_j["aux"]):
        np.testing.assert_allclose(a_p.numpy(), a_j, **tol)
    np.testing.assert_allclose(out_p["heatmaps"][-1].numpy(), out_j["heatmaps"][-1], **tol)
    assert_trees_close(state_dict_to_flax(pm.state_dict())[1], mut["batch_stats"], **tol)
    # the PCS embedding has one input a client
    emb_in = pm.state_dict()["encoder.pcs0.fc1_a.weight"].shape[1]
    assert emb_in == pcfg.num_clients


@pytest.fixture(scope="module")
def jax_ours():
    """JAX's ``ours_loss`` and its gradient, jitted once a (task, tree
    weight); the client id is traced."""
    cache = {}

    def get(task, tree_weight):
        if (task, tree_weight) not in cache:
            jcfg, _ = task_configs(task, tree_loss_weight=tree_weight)
            jm, _ = _flax_init(task)

            @jax.jit
            def f(params, stats, images, labels, cid):
                def loss_fn(p):
                    return jax_obj.ours_loss(jm, p, stats, jax.random.PRNGKey(0),
                                             {"image": images, "label": labels}, cid, jcfg)

                return jax.value_and_grad(loss_fn, has_aux=True)(params)

            cache[task, tree_weight] = f
        return cache[task, tree_weight]

    return get


@pytest.mark.parametrize("cid", [0, 2])
@pytest.mark.parametrize("tree_weight", [0.0, TREE_WEIGHT], ids=["tree-off", "tree-on"])
@pytest.mark.parametrize("task", TASKS)
def test_ours_loss_matches_jax(jax_ours, task, tree_weight, cid):
    """The first step from identical weights: every term, the argmax map,
    every gradient (the DSN heads' too when the tree term is on) and the
    running statistics after the own and the K - 1 contrast forwards."""
    _, pcfg = task_configs(task, tree_loss_weight=tree_weight)
    _, v, pm = task_models(task)
    image, label = task_batch(task, seed=cid)
    (loss_j, (stats_j, m_j)), grads_j = jax_ours(task, tree_weight)(
        v["params"], v["batch_stats"], jnp.asarray(image), jnp.asarray(label),
        jnp.asarray(cid, jnp.int32))

    pm.train()
    loss_p, m_p = port_obj.ours_loss(pm, {"image": t(image), "label": t(label)}, cid, pcfg)
    loss_p.backward()

    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5, atol=5e-6)
    for k in ("loss_ce", "loss_crf", "loss_lc", "loss_tree"):
        np.testing.assert_allclose(m_p[k].item(), float(m_j[k]), rtol=1e-5, atol=5e-6, err_msg=k)
    assert (m_p["loss_tree"].item() > 0.0) == (tree_weight > 0.0)
    np.testing.assert_array_equal(m_p["vis_pred"].numpy(), np.asarray(m_j["vis_pred"]))
    grads_p = _port_grads(pm)
    assert_trees_close(grads_p, grads_j, rtol=1e-4, atol=1e-5)
    dsn = grads_p["decoder"]["dsn_head1"]["out_kernel"]
    assert (np.abs(dsn).max() > 0) == (tree_weight > 0.0)  # the tree term reaches the DSN heads
    assert_trees_close(state_dict_to_flax(pm.state_dict())[1], stats_j, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("task", TASKS)
def test_gated_crf_route_matches_pallas(task):
    """The objective's gated-CRF route (``gated_crf_loss_auto``: on CPU
    tensors the kernel's plain twin) at the task's C and F = 2 + channels
    against JAX's Pallas kernel in interpret mode: the loss and its gradient
    to the probabilities."""
    _, pcfg = task_configs(task)
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(BATCH, IMG, IMG, pcfg.num_classes)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    image = rng.uniform(size=(BATCH, IMG, IMG, pcfg.in_chns)).astype(np.float32)
    value, grad = jax.value_and_grad(
        lambda p: gated_crf_loss_pallas(p, jnp.asarray(image), radius=pcfg.gatecrf_radius)
    )(jnp.asarray(probs))

    y = t(probs).requires_grad_(True)
    assert port_crf._planes(y, t(image))[1].shape[1] == 2 + pcfg.in_chns
    loss = port_crf.gated_crf_loss_auto(y, t(image), radius=pcfg.gatecrf_radius)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(value), rtol=1e-5)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(grad), rtol=1e-4, atol=1e-6)


@pytest.fixture
def native_lib():
    if not native.available():
        pytest.skip("fedicra_tpu's native library is unavailable (no g++)")


@pytest.mark.parametrize("task", TASKS)
def test_tree_chain_host_offload_matches_jax(native_lib, task):
    """The recursive multi-scale tree term with the task's image as its
    guide and C = 2 aux logits upsampled 4x, 2x and 1x, by
    ``host_offload=True`` on CPU tensors (the kernel route on its twins: one
    MST and one rooting call for the four trees, no plain filter) against
    JAX's native route. Held as tests/test_tree_host.py holds it: the value
    at rtol 2e-4, the gradients at rtol 5e-3 / atol 2e-4; AS is not held,
    since the upsampled guides' tie-breaks differ (ROADMAP section 3).

    FAZ's case gives the function the 1-channel image itself (D = 1), a
    function-level case that neither package's objective reaches: both
    repeat a gray image to 3 channels before the tree term."""
    _, pcfg = task_configs(task)
    c, h = pcfg.num_classes, 24
    rng = np.random.default_rng(50 + pcfg.in_chns)
    preds = rng.normal(size=(BATCH, h, h, c)).astype(np.float32)
    image = rng.uniform(size=(BATCH, h, h, pcfg.in_chns)).astype(np.float32)
    aux = [rng.normal(size=(BATCH, h // s, h // s, c)).astype(np.float32) for s in (4, 2, 1)]
    rois = (rng.uniform(size=(BATCH, h, h)) < 0.7).astype(np.float32)

    def f(p, a1, a2, a3):
        return jax_te.multi_scale_tree_energy_loss(
            p, jnp.asarray(image), a1, a2, a3, jnp.asarray(rois), TREE_WEIGHT,
            recursive=True, host_offload=True)[0]

    loss_j, grads_j = jax.value_and_grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (preds, *aux)))

    leaves = [t(a).requires_grad_(True) for a in (preds, *aux)]
    tree_filter.reset_calls()
    tree_filter_cuda.reset_launches()
    loss, *_ = port_te.multi_scale_tree_energy_loss(
        leaves[0], t(image), *leaves[1:], t(rois), TREE_WEIGHT, recursive=True, host_offload=True)
    loss.backward()
    assert tree_filter.calls == {"tree_filter_fwd": 0, "tree_filter_bwd": 0}
    assert tree_filter_cuda.launches == {"tree_mst": 0, "tree_root": 0, "tree_fwd": 0, "tree_bwd": 0}
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-4, atol=1e-6)
    for got, want in zip(leaves, grads_j):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=5e-3, atol=2e-4)
        assert np.abs(got.grad.numpy()).max() > 0


# The batch stream of the federated rounds: the first, not chosen. After 2
# rounds from a random init, a 2-class model's eval logits sit near the tie
# (margin -0.08 +- 0.09 on FAZ's client 3 under this stream), where the two
# packages' trained weights (apart by Adam's +-lr steps on rounding noise, as
# in tests/test_torch_federation_rounds.py) flip enough argmaxes to move a
# val dice by ~0.05: streams 0-3 gave 0.052, 0.014, 0.048 and 0.044 at most
# (ROADMAP section 3, "Numerical effects"). So here val dice after training is
# no parity signal at 0.05; the evaluation is held on JAX's weights at 1e-6.
STREAM = 0


def _task_round_arrays(task, seed, key, n):
    """``n`` batches of 2 of ``task``'s shape, a function of (batcher seed, key)."""
    rng = np.random.default_rng([seed, key, STREAM])
    parts = [task_batch(task, seed=int(rng.integers(2**31))) for _ in range(n)]
    return np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts])


def _patch_task_batchers(monkeypatch, task):
    """Both packages' batchers hand out the same numpy batches of ``task``,
    keyed by the batcher's seed and the round's first iteration (or the ALA
    epoch), as tests/test_torch_federation_rounds.py does for ODOC."""
    def jax_seed(b):
        return int(np.asarray(b.base_key)[-1])  # PRNGKey(seed) == [0, seed]

    def pair(arrays, wrap):
        return {"image": wrap(arrays[0]), "label": wrap(arrays[1])}

    arrays = partial(_task_round_arrays, task)
    monkeypatch.setattr(JaxBatcher, "batches_for_round", lambda b, start, iters: pair(
        arrays(jax_seed(b), start, iters), jnp.asarray))
    monkeypatch.setattr(JaxBatcher, "epoch_arrays", lambda b, epoch: tuple(
        jnp.asarray(a) for a in arrays(jax_seed(b), 10_000 + epoch, b.num_batches)))
    monkeypatch.setattr(EpochBatcher, "batches_for_round", lambda b, start, iters: pair(
        arrays(b.seed, start, iters), torch.as_tensor))
    monkeypatch.setattr(EpochBatcher, "epoch_arrays", lambda b, epoch: tuple(
        torch.as_tensor(a) for a in arrays(b.seed, 10_000 + epoch, b.num_batches)))


@pytest.mark.parametrize("task", TASKS)
def test_two_federated_rounds_match_jax(monkeypatch, task):
    """FedICRA "ours" (tree weight 0) for 2 rounds (iterations 2 and 4) in
    both packages from JAX's initial weights: the task's clients on its
    synthetic splits (its supervision types), ALA's first run in round 2,
    the evaluation at one foreground class. The losses and the aggregates
    at tests/test_torch_federation_rounds.py's tolerances, for its reasons;
    the evaluation by the port on JAX's trained weights at 1e-6, and the
    records' val dice only for range (see ``STREAM``)."""
    _patch_task_batchers(monkeypatch, task)
    for mod in (port_exp, jax_exp):
        monkeypatch.setattr(mod, "net_factory", partial(mod.net_factory, dropout=NO_DROPOUT,
                                                        dsn_dropout=0.0))
    base = dict(img_size=IMG, batch_size=BATCH, iters=2, rep_iters=1, eval_iters=2,
                max_iterations=8, model="unet_lc_multihead", strategy="FedICRA",
                procedure="ours", tree_loss_weight=0.0, ala_skip_iters=2)
    jserver = jax_exp.build_experiment(TrainConfig.for_task(task, **base), limit_per_client=4,
                                       synthetic=True)
    pcfg = PortConfig.for_task(task, **base)
    pserver = port_exp.build_experiment(pcfg, limit_per_client=4, synthetic=True, device="cpu")
    K = pcfg.num_clients
    assert len(jserver.clients) == len(pserver.clients) == K
    for jc, pc in zip(jserver.clients, pserver.clients):
        np.testing.assert_array_equal(pc.val_split.images, jc.val_split.images)
        np.testing.assert_array_equal(pc.val_split.labels, jc.val_split.labels)
        assert pc.val_split.images.shape[-1] == pcfg.in_chns
    v = jax.tree.map(np.asarray, jserver.global_payload)
    sd = flax_to_state_dict(v["params"], v["batch_stats"])
    model = pserver.clients[0].model
    params = {n: sd[n] for n, _ in model.named_parameters()}
    stats = {n: sd[n] for n, _ in model.named_buffers()}
    pserver.global_payload = {"params": params, "batch_stats": stats}
    for c in pserver.clients:
        c.state = ClientState(params, stats, 0, c.state.generator)
    jlog, plog = {}, {}
    _record_losses(jserver, jlog, np.asarray)
    _record_losses(pserver, plog, lambda a: a.numpy())
    for server in (jserver, pserver):
        _record_aggregates(server)
    jhist = jserver.run(num_rounds=4, progress=False)
    phist = pserver.run(num_rounds=4, progress=False)

    assert len(jhist) == len(phist) == 2
    got = np.stack([np.concatenate(plog[c]) for c in range(K)])
    want = np.stack([np.concatenate(jlog[c]) for c in range(K)])
    assert got.shape == want.shape == (K, 4)
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=5e-5, rtol=0)
    assert np.abs(got - want).max() < 0.08 and np.abs(got - want).mean() < 0.02
    lrs = [poly_lr(0.01, it, 8) for it in range(4)]
    for rnd, (g_port, g_jax) in enumerate(zip(pserver.aggregates, jserver.aggregates)):
        assert g_port.keys() == g_jax.keys()
        for k in g_jax:
            d = np.abs(g_port[k] - g_jax[k])
            assert d.max() <= 2 * sum(lrs[:2 * rnd + 2]), (rnd, "/".join(k))
            if rnd == 0 and k[-3:] != ("conv", "conv", "bias"):
                assert np.median(d) <= 1e-6, ("/".join(k), float(np.median(d)))
    for c, jc in enumerate(jserver.clients):
        jv = jax.tree.map(np.asarray, {"params": jc.state.params, "batch_stats": jc.state.batch_stats})
        jsd = flax_to_state_dict(jv["params"], jv["batch_stats"])
        m = evaluate_client(pserver.clients[c].model,
                            {k: jsd[k] for k in pserver.global_payload["params"]},
                            {k: jsd[k] for k in pserver.global_payload["batch_stats"]},
                            jc.val_split.images, jc.val_split.labels, pcfg.num_classes,
                            emb_idx=c, device="cpu")
        assert m["mean_dice"] == pytest.approx(jhist[-1][f"client_{c}_val_mean_dice"], abs=1e-6)
        assert m["mean_hd95"] == pytest.approx(jhist[-1][f"client_{c}_val_mean_hd95"], rel=1e-5)
        assert "class2_dice" not in m  # one foreground class
    for rec_p, rec_j in zip(phist, jhist):
        assert sorted(rec_p) == sorted(rec_j)
        for k in [f"client_{c}_val_mean_dice" for c in range(K)] + ["val_mean_dice"]:
            assert 0.0 <= rec_p[k] <= 1.0 and 0.0 <= rec_j[k] <= 1.0, k
        for c in range(K):
            assert rec_p[f"client_{c}_total_loss"] == pytest.approx(rec_j[f"client_{c}_total_loss"], abs=0.08)
    counts = [c._ala_epoch_counter for c in pserver.clients]
    assert counts == [c._ala_epoch_counter for c in jserver.clients]
    assert all(11 <= n <= 50 for n in counts)
    assert [c.start_phase for c in pserver.clients] == [False] * K
