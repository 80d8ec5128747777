"""The port's MST, Euler-tour tree and tree filter against fedicra_tpu's (CPU).

The MST and the tree are held bit-exactly on identical edge weights, made
once in numpy and fed to both packages. The filter is held against the JAX
function (float32, rtol 1e-5 / atol 1e-6 on y and its VJP, as both run the
same arithmetic in another order) and against the sequential numpy oracles
of ``fedicra_tpu/ops/tree_filter_ref.py`` (the port in float64 there).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.ops import mst as port_mst
from fedicra_torch.ops import tree_filter as port_tf
from fedicra_torch.ops.tree import build_tree
from fedicra_tpu.ops import mst as jax_mst
from fedicra_tpu.ops.tree import build_tree as jax_build_tree
from fedicra_tpu.ops.tree_filter_ref import root_tree, tree_filter_dense_oracle, tree_filter_oracle

# the package re-exports the function ``tree_filter`` under the module's name
jax_tf = importlib.import_module("fedicra_tpu.ops.tree_filter")

SHAPES = [(4, 5, False), (7, 6, False), (8, 8, True), (1, 9, False), (9, 1, False)]


def _weights(h, w, seed, ties=False, batch=None):
    rng = np.random.default_rng(seed)
    eu, ev = jax_mst.grid_edges(h, w)
    shape = (len(eu),) if batch is None else (batch, len(eu))
    ew = rng.uniform(1.0, 2.0, size=shape).astype(np.float32)
    if ties:
        ew = np.round(ew * 4) / 4  # many exact ties
    return eu, ev, ew


def _port_tree(eu, ev, sel, V):
    return build_tree(torch.as_tensor(eu), torch.as_tensor(ev), torch.as_tensor(sel)[None], V)


def test_grid_edges_are_the_jax_edges():
    for h, w in ((4, 5), (1, 9), (9, 1)):
        for got, want in zip(port_mst.grid_edges(h, w), jax_mst.grid_edges(h, w)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,ties", SHAPES)
def test_boruvka_matches_jax_and_kruskal(h, w, ties):
    eu, ev, ew = _weights(h, w, seed=h * 100 + w, ties=ties)
    V = h * w
    got = port_mst.boruvka_mst(torch.as_tensor(eu), torch.as_tensor(ev), torch.as_tensor(ew), V).numpy()
    want = np.asarray(jax_mst.boruvka_mst(jnp.asarray(eu), jnp.asarray(ev), jnp.asarray(ew), V))
    assert got.sum() == V - 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_mst.mst_oracle(eu, ev, ew, V))
    np.testing.assert_array_equal(port_mst.mst_oracle(eu, ev, ew, V), jax_mst.mst_oracle(eu, ev, ew, V))


@pytest.mark.parametrize("ties", [False, True])
def test_batched_mst_equals_the_mst_of_each_image(ties):
    h, w, nb = 6, 7, 4
    eu, ev, ews = _weights(h, w, seed=9, ties=ties, batch=nb)
    tu, tv = torch.as_tensor(eu), torch.as_tensor(ev)
    batched = port_mst.boruvka_mst(tu, tv, torch.as_tensor(ews), h * w).numpy()
    for b in range(nb):
        alone = port_mst.boruvka_mst(tu, tv, torch.as_tensor(ews[b]), h * w).numpy()
        np.testing.assert_array_equal(batched[b], alone)
        np.testing.assert_array_equal(batched[b], port_mst.mst_oracle(eu, ev, ews[b], h * w))


@pytest.mark.parametrize("h,w,ties", SHAPES + [(5, 7, False)])
def test_build_tree_matches_jax(h, w, ties):
    V = h * w
    eu, ev, ews = _weights(h, w, seed=3 + h, ties=ties, batch=3)
    sels = np.stack([jax_mst.mst_oracle(eu, ev, e, V) for e in ews])
    got = build_tree(torch.as_tensor(eu), torch.as_tensor(ev), torch.as_tensor(sels), V)
    for b in range(3):
        want = jax_build_tree(jnp.asarray(eu), jnp.asarray(ev), jnp.asarray(sels[b]), V)
        for name in want._fields:
            np.testing.assert_array_equal(getattr(got, name)[b].numpy(), np.asarray(getattr(want, name)), err_msg=name)


def _filter_case(h, w, scale, seed, c=3, dtype=np.float32):
    V = h * w
    eu, ev, ew = _weights(h, w, seed=seed)
    sel = jax_mst.mst_oracle(eu, ev, ew, V)
    ts = _port_tree(eu, ev, sel, V)
    jts = jax_build_tree(jnp.asarray(eu), jnp.asarray(ev), jnp.asarray(sel), V)
    parent_ref, bfs = root_tree(eu, ev, sel, V)
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(0.1, 1.0, size=(V, c)).astype(dtype)
    logw = (-scale * rng.uniform(0.0, 1.0, size=V)).astype(dtype)
    return ts, jts, parent_ref, bfs, x, logw


@pytest.mark.parametrize("h,w,scale", [(4, 4, 1.0), (6, 5, 1.0), (6, 5, 40.0), (9, 11, 3.0)])
def test_tree_filter_refine_matches_jax_and_oracles(h, w, scale):
    """scale=40 drives path products deep into underflow (logw ~ -40 per edge)."""
    ts, jts, parent_ref, bfs, x, logw = _filter_case(h, w, scale, seed=7)
    dfs = ts.dfs_vertices[0].numpy()
    pos = ts.dfs_pos[0].numpy()

    want = np.asarray(jax_tf.tree_filter_refine(
        jnp.asarray(x[dfs]), jnp.asarray(logw[dfs]), jts.parent_pos, jts.size))[pos]
    got = port_tf.tree_filter_refine(
        torch.as_tensor(x[dfs])[None], torch.as_tensor(logw[dfs])[None], ts.parent_pos, ts.size
    )[0].numpy()[pos]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    y_ref, _, _ = tree_filter_oracle(x, logw, parent_ref, bfs)
    got64 = port_tf.tree_filter_refine(
        torch.as_tensor(x[dfs].astype(np.float64))[None],
        torch.as_tensor(logw[dfs].astype(np.float64))[None], ts.parent_pos, ts.size,
    )[0].numpy()[pos]
    np.testing.assert_allclose(got64, y_ref, rtol=1e-10, atol=1e-12)
    if h * w <= 30:
        np.testing.assert_allclose(got64, tree_filter_dense_oracle(x, logw, parent_ref), rtol=1e-9, atol=1e-12)


def test_tree_filter_refine_vjp_matches_jax_and_finite_differences():
    h, w = 5, 6
    ts, jts, parent_ref, bfs, x, logw = _filter_case(h, w, 2.0, seed=11, c=2)
    dfs = ts.dfs_vertices[0].numpy()
    pos = ts.dfs_pos[0].numpy()
    g = np.random.default_rng(13).normal(size=x.shape).astype(np.float32)

    def loss_jax(xd, lw):
        y = jax_tf.tree_filter_refine(xd, lw, jts.parent_pos, jts.size)
        return jnp.sum(y * jnp.asarray(g[dfs]))

    dx_j, dlogw_j = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(x[dfs]), jnp.asarray(logw[dfs]))

    def port_grads(dtype):
        xd = torch.tensor(x[dfs], dtype=dtype)[None].requires_grad_(True)
        lw = torch.tensor(logw[dfs], dtype=dtype)[None].requires_grad_(True)
        y = port_tf.tree_filter_refine(xd, lw, ts.parent_pos, ts.size)
        (y * torch.tensor(g[dfs], dtype=dtype)[None]).sum().backward()
        return xd.grad[0].numpy(), lw.grad[0].numpy()

    dx, dlogw = port_grads(torch.float32)
    np.testing.assert_allclose(dx, np.asarray(dx_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dlogw, np.asarray(dlogw_j), rtol=1e-5, atol=1e-6)

    # central differences through the numpy oracle, against the port in float64
    def loss_np(x_, lw_):
        y, _, _ = tree_filter_oracle(x_, lw_, parent_ref, bfs)
        return float(np.sum(y * g))

    x64, lw64, eps = x.astype(np.float64), logw.astype(np.float64), 1e-6
    dx_fd = np.zeros_like(x64)
    for i in range(x.shape[0]):
        for c in range(x.shape[1]):
            xp, xm = x64.copy(), x64.copy()
            xp[i, c] += eps
            xm[i, c] -= eps
            dx_fd[i, c] = (loss_np(xp, lw64) - loss_np(xm, lw64)) / (2 * eps)
    dlogw_fd = np.zeros_like(lw64)
    for i in range(len(lw64)):
        lp, lm = lw64.copy(), lw64.copy()
        lp[i] += eps
        lm[i] -= eps
        dlogw_fd[i] = (loss_np(x64, lp) - loss_np(x64, lm)) / (2 * eps)
    dlogw_fd[dfs[0]] = 0.0  # the root has no edge
    dx64, dlogw64 = port_grads(torch.float64)
    np.testing.assert_allclose(dx64[pos], dx_fd, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(dlogw64[pos], dlogw_fd, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("low_tree", [True, False])
def test_tree_filter_wrapper_matches_jax(low_tree):
    """Batched over 2 images; the high tree passes gradients on to the embedding."""
    h, w, nb = 6, 7, 2
    V = h * w
    rng = np.random.default_rng(17 + low_tree)
    feat = rng.uniform(size=(nb, V, 3)).astype(np.float32)
    embed = (0.3 * rng.normal(size=(nb, V, 2))).astype(np.float32)
    g = rng.normal(size=(nb, V, 3)).astype(np.float32)
    eu, ev = jax_mst.grid_edges(h, w)
    sels = np.stack([jax_mst.mst_oracle(eu, ev, rng.uniform(1, 2, len(eu)), V) for _ in range(nb)])
    ts = build_tree(torch.as_tensor(eu), torch.as_tensor(ev), torch.as_tensor(sels), V)
    sigma = 0.5

    f_t = torch.tensor(feat, requires_grad=True)
    e_t = torch.tensor(embed, requires_grad=True)
    y = port_tf.tree_filter(f_t, e_t, ts, sigma=sigma, low_tree=low_tree)
    (y * torch.as_tensor(g)).sum().backward()
    de = torch.zeros_like(e_t) if low_tree else e_t.grad

    for b in range(nb):
        jts = jax_build_tree(jnp.asarray(eu), jnp.asarray(ev), jnp.asarray(sels[b]), V)

        def loss(fe, em):
            out = jax_tf.tree_filter(fe, em, jts, sigma=sigma, low_tree=low_tree)
            return jnp.sum(out * jnp.asarray(g[b])), out

        (_, y_j), (df_j, de_j) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(feat[b]), jnp.asarray(embed[b]))
        np.testing.assert_allclose(y[b].detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(f_t.grad[b].numpy(), np.asarray(df_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(de[b].numpy(), np.asarray(de_j), rtol=1e-4, atol=1e-6)
    if low_tree:
        assert e_t.grad is None
    else:
        assert e_t.grad.abs().max() > 1e-3


def test_filter_calls_are_counted_once_per_forward_and_backward():
    ts, _, _, _, x, logw = _filter_case(4, 4, 1.0, seed=7)
    xd = torch.tensor(x, requires_grad=True)[None]
    port_tf.reset_calls()
    port_tf.tree_filter_refine(xd, torch.as_tensor(logw)[None], ts.parent_pos, ts.size).sum().backward()
    assert port_tf.calls == {"tree_filter_fwd": 1, "tree_filter_bwd": 1}
