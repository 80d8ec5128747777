"""The port's native tree-chain route against fedicra_tpu's native C++ (CPU).

``fedicra_torch/ops/tree_filter_cuda.py`` holds four CUDA kernels (MST
selection, BFS rooting, the filter's forward, its backward) and a plain
PyTorch twin of each, which CPU tensors take. The same numpy inputs go
through each twin and through ``fedicra_tpu.native`` (``boruvka_mst_batch``,
``tree_low_structure_build``, ``tree_filter_host_batch``), and through the
port's losses and JAX's ``host_offload=True``: on CPU tensors the port's
``host_offload=True`` runs the kernel route's composition on the twins.

Tolerances: the MST, BFS order and parents are exact (a unique MST under the
order (weight, edge index), and the same queue discipline). The filter
weights w = exp(-dist / sigma) are held at rtol 1e-6: the twin forms dist as
the native code compiles it (fused multiply-adds), and the exps of the two
libraries differ by an ulp. The filter's output runs the same passes in the
same order (rtol 1e-5 / atol 1e-6); its gradients add the crossing-pair
terms in another order (rtol 2e-3 / atol 2e-5). The losses are held at
``tests/test_tree_host.py``'s tolerances: value rtol 2e-4, AS rtol 2e-3 /
atol 2e-5, gradients rtol 5e-3 / atol 2e-4 (the L1's sign can flip where
prob and AS nearly meet).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.losses import tree_energy as port_te
from fedicra_torch.ops import tree_filter, tree_filter_cuda
from fedicra_torch.ops.mst import grid_edges
from fedicra_tpu import native
from fedicra_tpu.losses import tree_energy as jax_te
from test_torch_kernels import _structure_weights
from torch_port_helpers import one_torch_thread, t  # noqa: F401

SIGMA = 0.02
SHAPES = [(2, 12, 12), (3, 13, 17), (4, 24, 24)]  # (B, H, W)


@pytest.fixture
def native_lib():
    if not native.available():
        pytest.skip("fedicra_tpu's native library is unavailable (no g++)")


def _mst_weights(embed, eu, ev):
    """||d embed||^2 + 1 per edge, [B, E] (numpy, as a guide's MST weights)."""
    return np.stack([((e[eu] - e[ev]) ** 2).sum(-1) + 1.0 for e in embed]).astype(np.float32)


def _noise(rng, b, v, d, scale=1.0):
    return (scale * rng.uniform(size=(b, v, d))).astype(np.float32)


def _root_twice(sel, embed, h, w, n_low):
    """``tree_root`` on CPU tensors (the BFS twin), twice on the same inputs:
    all seven arrays must come back with the same bits."""
    first, second = (tree_filter_cuda.tree_root(sel, embed, h, w, n_low, SIGMA) for _ in range(2))
    for name, a, b in zip(tree_filter_cuda.BFSTree._fields, first, second):
        assert a.dtype == b.dtype and torch.equal(a, b), (
            f"tree_root_plain gave two {name} arrays on the same inputs (sel {tuple(sel.shape)}, "
            f"embed {tuple(embed.shape)}, h={h}, w={w}, n_low={n_low}): max |diff| "
            f"{(a.double() - b.double()).abs().max().item():.3g}")
    return first


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mst_twin_equals_native_boruvka(native_lib, shape):
    b, h, w = shape
    eu, ev = grid_edges(h, w)
    weights = _mst_weights(_noise(np.random.default_rng(h), b, h * w, 3), eu, ev)
    got = tree_filter_cuda.tree_mst(torch.tensor(weights), h, w)
    assert got.dtype == torch.bool and got.shape == weights.shape
    np.testing.assert_array_equal(got.numpy(), native.boruvka_mst_batch(eu, ev, weights))
    assert (got.sum(1) == h * w - 1).all()


def _assert_tree_consistent(tree, h, w):
    """Queue, parents, parent positions, child ranges and levels agree."""
    V = h * w
    order, parent, ppos = (a.long().numpy() for a in tree[:3])
    cptr, level, nlev = tree.cptr.long().numpy(), tree.level.long().numpy(), tree.n_levels.numpy()
    for b in range(order.shape[0]):
        assert sorted(order[b]) == list(range(V)) and order[b, 0] == 0
        q = np.arange(1, V)
        np.testing.assert_array_equal(order[b, ppos[b, q]], parent[b, order[b, q]])
        assert (ppos[b, q] < q).all()
        assert (cptr[b, ppos[b, q]] <= q).all() and (q < cptr[b, ppos[b, q] + 1]).all()
        assert cptr[b, V] == V and (np.diff(cptr[b]) >= 0).all()
        depth = np.zeros(V, dtype=int)
        for i in q:
            depth[i] = depth[ppos[b, i]] + 1
        assert nlev[b] == depth.max() + 1 and level[b, nlev[b]] == V
        for L in range(nlev[b]):
            assert (depth[level[b, L]:level[b, L + 1]] == L).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_root_twin_equals_native_low_structure(native_lib, shape):
    """The BFS queue and parents exactly, the low tree's weights at rtol 1e-6."""
    b, h, w = shape
    eu, ev = grid_edges(h, w)
    low = _noise(np.random.default_rng(h + 1), b, h * w, 3)
    parent, order, weights = native.tree_low_structure_build(low, eu, ev, SIGMA)
    sel = tree_filter_cuda.tree_mst(torch.tensor(_mst_weights(low, eu, ev)), h, w)
    tree = _root_twice(sel, torch.tensor(low), h, w, b)
    np.testing.assert_array_equal(tree.order.numpy(), order)
    np.testing.assert_array_equal(tree.parent.numpy(), parent)
    # atol: the smallest normal fp32; below it exp's result is denormal
    np.testing.assert_allclose(tree.w.numpy(), weights, rtol=1e-6, atol=1.2e-38)
    assert tree.w.numpy()[:, 1:].max() > 1e-3  # not all underflowed
    _assert_tree_consistent(tree, h, w)


def test_root_twin_gives_high_trees_unit_sigma():
    """Images past ``n_low`` take exp(-dist), not exp(-dist / sigma)."""
    h, w, b = 9, 11, 2
    eu, ev = grid_edges(h, w)
    emb = _noise(np.random.default_rng(3), 2 * b, h * w, 2)
    sel = tree_filter_cuda.tree_mst(torch.tensor(_mst_weights(emb, eu, ev)), h, w)
    tree = _root_twice(sel, torch.tensor(emb), h, w, b)
    order, parent = tree.order.long(), tree.parent.long()
    e = torch.tensor(emb)
    diff = e.gather(1, order[..., None].expand(-1, -1, 2)) - e.gather(
        1, parent.gather(1, order)[..., None].expand(-1, -1, 2))
    dist = (diff.double() ** 2).sum(-1)
    want = torch.exp(-dist * torch.tensor([50.0] * b + [1.0] * b, dtype=torch.float64)[:, None])
    want[:, 0] = 0.0
    torch.testing.assert_close(tree.w.double(), want, rtol=2e-6, atol=1e-30)
    _assert_tree_consistent(tree, h, w)


@pytest.mark.parametrize("low_tree", [True, False], ids=["low", "high"])
@pytest.mark.parametrize("c", [2, 3])
def test_filter_twins_match_native_filter(native_lib, low_tree, c):
    """K3's and K4's twins through ``TreeFilter`` against
    ``tree_filter_host_batch``: y, dx and (high tree) d embed."""
    b, h, w = 3, 16, 20
    V = h * w
    rng = np.random.default_rng(10 * c + low_tree)
    eu, ev = grid_edges(h, w)
    embed = _noise(rng, b, V, 3) if low_tree else rng.normal(size=(b, V, c)).astype(np.float32)
    x = _noise(rng, b, V, c)
    g = rng.normal(size=(b, V, c)).astype(np.float32)
    y_n, dx_n, de_n = native.tree_filter_host_batch(embed, x, eu, ev, SIGMA, low_tree, gout=g)

    sel = tree_filter_cuda.tree_mst(torch.tensor(_mst_weights(embed, eu, ev)), h, w)
    tree = tree_filter_cuda.tree_root(sel, torch.tensor(embed), h, w, b if low_tree else 0, SIGMA)
    xt, et = t(x).requires_grad_(True), t(embed).requires_grad_(not low_tree)
    tree_filter_cuda.reset_launches()
    y = tree_filter_cuda.tree_filter(xt, et, tree, low_tree=low_tree)
    y.backward(t(g))
    assert tree_filter_cuda.launches == {"tree_mst": 0, "tree_root": 0, "tree_fwd": 0, "tree_bwd": 0}
    np.testing.assert_allclose(y.detach().numpy(), y_n, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), dx_n, rtol=2e-3, atol=2e-5)
    if low_tree:
        assert et.grad is None
    else:
        np.testing.assert_allclose(et.grad.numpy(), de_n, rtol=2e-3, atol=2e-5)
        assert np.abs(de_n).max() > 1e-2


def test_filter_widens_bf16_feature():
    """A bf16 feature is filtered in fp32 (y fp32); its gradient comes back bf16."""
    b, h, w, c = 2, 8, 9, 3
    rng = np.random.default_rng(4)
    eu, ev = grid_edges(h, w)
    embed = rng.normal(size=(b, h * w, c)).astype(np.float32)
    sel = tree_filter_cuda.tree_mst(torch.tensor(_mst_weights(embed, eu, ev)), h, w)
    tree = tree_filter_cuda.tree_root(sel, torch.tensor(embed), h, w, 0, SIGMA)
    x16 = t(_noise(rng, b, h * w, c)).to(torch.bfloat16).requires_grad_(True)
    x32 = x16.detach().float().requires_grad_(True)
    g = t(rng.normal(size=(b, h * w, c)).astype(np.float32))
    outs = [tree_filter_cuda.tree_filter(x, t(embed), tree, low_tree=False) for x in (x16, x32)]
    assert outs[0].dtype == torch.float32 and torch.equal(outs[0], outs[1])
    for out in outs:
        out.backward(g)
    assert x16.grad.dtype == torch.bfloat16
    assert torch.equal(x16.grad, x32.grad.to(torch.bfloat16))


def _loss_inputs(seed, b=2, h=24, w=24, c=3, aux_scales=(4, 2, 1)):
    rng = np.random.default_rng(seed)
    preds = rng.normal(size=(b, h, w, c)).astype(np.float32)
    image = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    aux = [rng.normal(size=(b, h // s, w // s, c)).astype(np.float32) for s in aux_scales]
    rois = (rng.uniform(size=(b, h, w)) < 0.7).astype(np.float32)
    return preds, image, aux, rois


def _jax_native_loss(preds, image, aux, rois, recursive):
    def f(p, a1, a2, a3):
        out = jax_te.multi_scale_tree_energy_loss(
            p, jnp.asarray(image), a1, a2, a3, jnp.asarray(rois), 0.1,
            recursive=recursive, host_offload=True)
        return out[0], out[1:]

    (loss, AS), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (preds, *aux)))
    return float(loss), [np.asarray(a) for a in AS], [np.asarray(g) for g in grads]


def _port_loss(preds, image, aux, rois, recursive, host_offload=None):
    leaves = [t(a).requires_grad_(True) for a in (preds, *aux)]
    loss, *AS = port_te.multi_scale_tree_energy_loss(
        leaves[0], t(image), *leaves[1:], t(rois), 0.1, recursive=recursive,
        host_offload=host_offload)
    loss.backward()
    return loss.item(), [a.detach().numpy() for a in AS], [x.grad.numpy() for x in leaves]


def _assert_losses_close(got, want, same_trees=True):
    (loss, AS, grads), (loss_j, AS_j, grads_j) = got, want
    np.testing.assert_allclose(loss, loss_j, rtol=2e-4, atol=1e-6)
    for a, b in zip(AS, AS_j) if same_trees else ():
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5)
    for a, b in zip(grads, grads_j):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=2e-4)
    assert all(np.abs(g).max() > 0 for g in grads)


# Aux logits at full resolution, and upsampled 4x, 2x and 1x as the model's
# are. Upsampling makes exact ties in the high trees' MST weights, which the
# native C++ (fused multiply-adds) and the port's ``mst_edge_weights`` (a
# channel sum) round apart, so a few edges differ and AS_k differs near them
# (ROADMAP, "Tie-breaks"); the loss and the gradients stay inside their
# tolerances, and AS_k is held only where both build the same trees.
AUX_SCALES = [(1, 1, 1), (4, 2, 1)]


@pytest.mark.parametrize("aux_scales", AUX_SCALES, ids=["full-res", "upsampled"])
@pytest.mark.parametrize("recursive", [True, False], ids=["recursive", "additive"])
def test_port_loss_matches_jax_host_offload(native_lib, recursive, aux_scales):
    """The port's default route on CPU tensors (the plain one) against JAX's
    native route."""
    inputs = _loss_inputs(seed=20 + recursive, aux_scales=aux_scales)
    tree_filter.reset_calls()
    got = _port_loss(*inputs, recursive)
    assert tree_filter.calls == {"tree_filter_fwd": 4, "tree_filter_bwd": 4}
    _assert_losses_close(got, _jax_native_loss(*inputs, recursive), aux_scales == (1, 1, 1))


@pytest.mark.parametrize("aux_scales", AUX_SCALES, ids=["full-res", "upsampled"])
@pytest.mark.parametrize("recursive", [True, False], ids=["recursive", "additive"])
def test_native_route_twins_match_jax_host_offload(native_lib, recursive, aux_scales):
    """``host_offload=True`` on CPU tensors, as JAX's: the kernel route's
    composition (one MST and one rooting call for the four trees, then the
    four filters) on its CPU twins against JAX's native route."""
    inputs = _loss_inputs(seed=30 + recursive, aux_scales=aux_scales)
    tree_filter.reset_calls()
    tree_filter_cuda.reset_launches()
    got = _port_loss(*inputs, recursive, host_offload=True)
    assert tree_filter.calls == {"tree_filter_fwd": 0, "tree_filter_bwd": 0}
    assert tree_filter_cuda.launches == {"tree_mst": 0, "tree_root": 0, "tree_fwd": 0, "tree_bwd": 0}
    _assert_losses_close(got, _jax_native_loss(*inputs, recursive), aux_scales == (1, 1, 1))


@pytest.mark.parametrize("with_high", [False, True], ids=["low-only", "with-high"])
def test_single_scale_host_offload_matches_jax(native_lib, with_high):
    """``tree_energy_loss(..., host_offload=True)`` on CPU tensors (the
    twins) against JAX's ``host_offload=True``: the loss, AS and the
    gradients to the logits and, with a high tree, to the aux logits."""
    preds, image, aux, rois = _loss_inputs(seed=40 + with_high, aux_scales=(1, 1, 1))
    high = aux[0] if with_high else None

    def f(p, a):
        return jax_te.tree_energy_loss(p, jnp.asarray(image), a, jnp.asarray(rois), 0.1,
                                       host_offload=True)

    argnums = (0, 1) if with_high else (0,)
    (loss_j, AS_j), grads_j = jax.value_and_grad(f, argnums=argnums, has_aux=True)(
        jnp.asarray(preds), None if high is None else jnp.asarray(high))
    leaves = [t(preds).requires_grad_(True)] + ([t(high).requires_grad_(True)] if with_high else [])
    tree_filter.reset_calls()
    loss, AS = port_te.tree_energy_loss(leaves[0], t(image), leaves[1] if with_high else None,
                                        t(rois), 0.1, host_offload=True)
    loss.backward()
    assert tree_filter.calls == {"tree_filter_fwd": 0, "tree_filter_bwd": 0}
    _assert_losses_close((loss.item(), [AS.detach().numpy()], [x.grad.numpy() for x in leaves]),
                         (float(loss_j), [np.asarray(AS_j)], [np.asarray(g) for g in grads_j]))


@pytest.mark.parametrize("with_high", [False, True], ids=["low-only", "with-high"])
def test_native_route_equals_plain_route_single_scale(with_high):
    """``tree_energy_loss`` by both routes on the same inputs (same trees,
    other filter arithmetic)."""
    preds, image, aux, rois = _loss_inputs(seed=7, h=16, w=16, aux_scales=(1, 1, 1))
    high = t(aux[0]) if with_high else None
    plain = port_te.tree_energy_loss(t(preds), t(image), high, t(rois), 0.1)
    kernel_route = port_te.tree_energy_loss(t(preds), t(image), high, t(rois), 0.1, host_offload=True)
    np.testing.assert_allclose(kernel_route[0].item(), plain[0].item(), rtol=1e-5)
    np.testing.assert_allclose(kernel_route[1].numpy(), plain[1].numpy(), rtol=1e-4, atol=1e-6)


TWINS = ("tree_mst_plain", "tree_root_plain", "tree_filter_fwd_plain", "tree_filter_bwd_plain")


def test_host_offload_dispatch_on_cpu_tensors(monkeypatch):
    """None and False take the plain route on CPU tensors; True takes the
    native route's twins (one MST and one rooting call for all trees, a
    forward twin a tree), with no kernel launch and no plain filter run."""
    twin_calls = dict.fromkeys(TWINS, 0)
    for name in TWINS:
        def spy(*args, _name=name, _fn=getattr(tree_filter_cuda, name), **kwargs):
            twin_calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(tree_filter_cuda, name, spy)
    preds, image, aux, rois = _loss_inputs(seed=9, h=12, w=12)
    preds, image, rois, aux = t(preds), t(image), t(rois), [t(a) for a in aux]
    tree_filter_cuda.reset_launches()
    for host_offload in (None, False):
        tree_filter.reset_calls()
        port_te.multi_scale_tree_energy_loss(preds, image, *aux, rois, 0.1, host_offload=host_offload)
        assert tree_filter.calls == {"tree_filter_fwd": 4, "tree_filter_bwd": 0}
        tree_filter.reset_calls()
        port_te.tree_energy_loss(preds, image, aux[2], rois, 0.1, host_offload=host_offload)
        assert tree_filter.calls == {"tree_filter_fwd": 2, "tree_filter_bwd": 0}
    assert twin_calls == dict.fromkeys(TWINS, 0)
    tree_filter.reset_calls()
    port_te.multi_scale_tree_energy_loss(preds, image, *aux, rois, 0.1, host_offload=True)
    assert twin_calls == {"tree_mst_plain": 1, "tree_root_plain": 1, "tree_filter_fwd_plain": 4,
                          "tree_filter_bwd_plain": 0}
    twin_calls.update(dict.fromkeys(TWINS, 0))
    loss, _ = port_te.tree_energy_loss(preds.requires_grad_(True), image, None, rois, 0.1,
                                       host_offload=True)
    loss.backward()
    assert twin_calls == {"tree_mst_plain": 1, "tree_root_plain": 1, "tree_filter_fwd_plain": 1,
                          "tree_filter_bwd_plain": 1}
    assert tree_filter.calls == {"tree_filter_fwd": 0, "tree_filter_bwd": 0}
    assert tree_filter_cuda.launches == {"tree_mst": 0, "tree_root": 0, "tree_fwd": 0, "tree_bwd": 0}


def test_kernel_wrappers_refuse_cpu_tensors_before_launching():
    h, w, b, c = 4, 5, 1, 2
    E, V = tree_filter_cuda.num_grid_edges(h, w), h * w
    tree_filter_cuda.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tree_filter_cuda.tree_mst_cuda(torch.ones(b, E), h, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tree_filter_cuda.tree_root_cuda(torch.ones(b, E, dtype=torch.bool), torch.zeros(b, V, c),
                                        h, w, b, SIGMA)
    sel = tree_filter_cuda.tree_mst(torch.rand(b, E), h, w)
    tree = tree_filter_cuda.tree_root(sel, torch.rand(b, V, c), h, w, b, SIGMA)
    x = torch.rand(b, V, c)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tree_filter_cuda.tree_filter_fwd_cuda(x, tree)
    A, F, y = tree_filter_cuda.tree_filter_fwd_plain(x, tree)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tree_filter_cuda.tree_filter_bwd_cuda(x, y, A, F, tree, None)
    assert tree_filter_cuda.launches == {"tree_mst": 0, "tree_root": 0, "tree_fwd": 0, "tree_bwd": 0}


# ---- a numpy model of K1's and K2's designs ---------------------------------
#
# csrc/tree_filter.cu finds the MST in two phases and roots it by a BFS
# driven by per-vertex masks. The model below follows the same rules (not
# the same code paths: it runs every tile at once), so a wrong rule shows
# against the native C++ here, before the kernels run on a card.

NO_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)
LOW32 = np.uint64(0xFFFFFFFF)


def _edge_keys(weights):
    """The kernels' uint64 keys: the weight's bits over the edge index."""
    bits = np.ascontiguousarray(weights, np.float32).view(np.uint32).astype(np.uint64)
    return bits << np.uint64(32) | np.arange(weights.shape[-1], dtype=np.uint64)


def _jump(hook):
    while not np.array_equal(hook[hook], hook):
        hook = hook[hook]
    return hook


def _least_keys(n, lu, lv, keys):
    best = np.full(n, NO_KEY)
    np.minimum.at(best, lu, keys)
    np.minimum.at(best, lv, keys)
    return best


def model_mst(weights, h, w, tile):
    """K1's two phases on one image: (selection bool [E], counts).

    Phase 1, per tile: a component takes its least key over every edge at its
    vertices; it hooks across that edge when the edge lies inside the tile
    (a mutual pair's smaller id stays root) and waits when it leaves the
    tile; rounds run until no component hooks. Phase 2: the edges that join
    two components, one a pair with the least key, in rounds that drop the
    edges inside one component."""
    eu, ev = (a.astype(np.int64) for a in grid_edges(h, w))
    V = h * w
    keys = _edge_keys(weights)
    ar = np.arange(V)
    tile_of = (ar // w) // tile * -(-w // tile) + (ar % w) // tile
    leaves = tile_of[eu] != tile_of[ev]
    comp, sel = ar.copy(), np.zeros(len(eu), bool)
    rounds = 0
    while True:
        cand = leaves | (comp[eu] != comp[ev])
        best = _least_keys(V, comp[eu[cand]], comp[ev[cand]], keys[cand])
        roots = np.flatnonzero((comp == ar) & (best != NO_KEY))
        e = (best[roots] & LOW32).astype(np.int64)
        roots, e = roots[~leaves[e]], e[~leaves[e]]
        if len(roots) == 0:
            break
        rounds += 1
        cu = comp[eu[e]]
        other = np.where(cu == roots, comp[ev[e]], cu)
        hook = ar.copy()
        hook[roots] = np.where((best[other] == best[roots]) & (roots < other), roots, other)
        sel[e] = True
        comp = _jump(hook)[comp]
    lu, lv = comp[eu], comp[ev]
    keep = lu != lv
    lo, hi, k = np.minimum(lu, lv)[keep], np.maximum(lu, lv)[keep], keys[keep]
    pair = lo * V + hi
    order = np.lexsort((k, pair))  # by pair, then key: each pair's least first
    head = np.ones(len(order), bool)
    head[1:] = pair[order][1:] != pair[order][:-1]
    lu, lv, k = lo[order][head], hi[order][head], k[order][head]
    counts = dict(p1_rounds=rounds, components=int((comp == ar).sum()), edges=len(k))
    p2 = 0
    while len(k):
        best = _least_keys(V, lu, lv, k)
        hook = ar.copy()
        for a, b in ((lu, lv), (lv, lu)):
            mine = k == best[a]
            hook[a[mine]] = np.where((best[b[mine]] == k[mine]) & (a[mine] < b[mine]), a[mine], b[mine])
        sel[(k[(k == best[lu]) | (k == best[lv])] & LOW32).astype(np.int64)] = True
        hook = _jump(hook)
        lu, lv = hook[lu], hook[lv]
        live = lu != lv
        lu, lv, k = lu[live], lv[live], k[live]
        p2 += 1
    counts["p2_rounds"] = p2
    return sel, counts


def model_bfs(sel, h, w):
    """K2's BFS from per-vertex masks (bit 0 right, 1 left, 2 down, 3 up):
    a vertex's children are its mask less the bit toward its parent, in bit
    order. Returns (order, parent, ppos, cptr, level offsets)."""
    V, NV = h * w, (h - 1) * w
    i, j = np.divmod(np.arange(V), w)
    s = np.concatenate([np.asarray(sel, bool), [False]])
    E = len(s) - 1
    at = lambda ok, e: ok & s[np.where(ok, e, E)]
    row = NV + i * (w - 1)
    mask = (at(j + 1 < w, row + j) * 1 + at(j > 0, row + j - 1) * 2
            + at(i + 1 < h, np.arange(V)) * 4 + at(i > 0, np.arange(V) - w) * 8)
    delta = (1, -1, w, -w)
    order, to_parent, ppos, cptr = [0], [-1], [0], []
    parent = np.zeros(V, np.int64)
    levels, start, end = [0, 1], 0, 1
    while True:
        for p in range(start, end):
            u = order[p]
            m = mask[u] & ~(1 << to_parent[p] if p else 0)
            cptr.append(len(order))
            for d in range(4):
                if m >> d & 1:
                    order.append(u + delta[d])
                    to_parent.append(d ^ 1)
                    ppos.append(p)
                    parent[u + delta[d]] = u
        if len(order) == end:
            break
        start, end = end, len(order)
        levels.append(end)
    return np.array(order), parent, np.array(ppos), np.array(cptr + [V]), np.array(levels)


MODEL_CASES = [  # (kind, h, w, tile): tiles that do not divide H or W, and 1 x N, N x 1
    ("random", 24, 24, 8), ("random", 33, 37, 8), ("random", 33, 37, 32), ("random", 1, 70, 8),
    ("random", 70, 1, 8), ("equal", 33, 37, 8), ("equal", 1, 70, 8), ("equal", 70, 1, 8),
    ("serpentine", 33, 37, 8), ("serpentine", 32, 32, 8), ("comb", 33, 37, 8), ("comb", 40, 24, 8),
]


@pytest.mark.parametrize("kind, h, w, tile", MODEL_CASES, ids=lambda v: str(v))
def test_mst_model_equals_native_boruvka(native_lib, kind, h, w, tile):
    """The two-phase design's selection, bit for bit the native C++'s; phase
    1 leaves work for phase 2 wherever the image spans several tiles."""
    weights = _structure_weights(kind, h, w, np.random.default_rng(h * w + tile))
    sel, counts = model_mst(weights, h, w, tile)
    eu, ev = grid_edges(h, w)
    np.testing.assert_array_equal(sel, native.boruvka_mst_batch(eu, ev, weights[None])[0])
    assert sel.sum() == h * w - 1
    if h > tile or w > tile:
        assert counts["components"] > 1 and counts["p2_rounds"] >= 1, counts
    assert counts["edges"] <= tree_filter_cuda.num_grid_edges(h, w)


@pytest.mark.parametrize("guide", ["random", "equal"])
@pytest.mark.parametrize("h, w", [(24, 24), (33, 37), (1, 70), (70, 1)], ids=lambda v: str(v))
def test_bfs_model_equals_native_low_structure(native_lib, guide, h, w):
    """The mask-driven BFS on the two-phase MST of a guide: order and
    parents exactly ``tree_low_structure_build``'s (a constant guide gives
    equal weights, where the edge index decides every tie)."""
    rng = np.random.default_rng(h + 7 * w)
    eu, ev = grid_edges(h, w)
    low = _noise(rng, 1, h * w, 3) if guide == "random" else np.full((1, h * w, 3), 0.5, np.float32)
    parent, order, _ = native.tree_low_structure_build(low, eu, ev, SIGMA)
    sel, _ = model_mst(_mst_weights(low, eu, ev)[0], h, w, 8)
    got_order, got_parent, *_ = model_bfs(sel, h, w)
    np.testing.assert_array_equal(got_order, order[0])
    np.testing.assert_array_equal(got_parent, parent[0])


@pytest.mark.parametrize("kind, h, w", [("serpentine", 33, 37), ("comb", 33, 37), ("comb", 40, 24),
                                        ("random", 1, 70), ("random", 70, 1)], ids=lambda v: str(v))
def test_bfs_model_equals_bfs_twin(kind, h, w):
    """The mask-driven BFS against the BFS twin on the same selection: the
    queue, parents, parent positions, child ranges and level offsets (a
    path-shaped tree of V levels, a comb whose middle levels are widest)."""
    sel = tree_filter_cuda.tree_mst_plain(
        torch.tensor(_structure_weights(kind, h, w, np.random.default_rng(5)))[None], h, w)
    twin = tree_filter_cuda.tree_root_plain(sel, torch.zeros(1, h * w, 1), h, w, 1, SIGMA)
    order, parent, ppos, cptr, levels = model_bfs(sel[0].numpy(), h, w)
    np.testing.assert_array_equal(order, twin.order[0].numpy())
    np.testing.assert_array_equal(parent, twin.parent[0].numpy())
    np.testing.assert_array_equal(ppos, twin.ppos[0].numpy())
    np.testing.assert_array_equal(cptr, twin.cptr[0].numpy())
    n_levels = int(twin.n_levels[0])
    assert len(levels) == n_levels + 1
    np.testing.assert_array_equal(levels, twin.level[0, :n_levels + 1].numpy())
    if kind == "serpentine":
        assert n_levels == h * w
