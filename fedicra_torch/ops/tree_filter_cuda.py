"""The tree-energy chain's native route: CUDA kernels, their plain twins, autograd.

Counterpart of ``fedicra_tpu/ops/tree_filter_host.py`` and of
``fedicra_tpu/native/__init__.py``'s ``boruvka_mst_batch`` (:90),
``tree_filter_host_batch`` (:122) and ``tree_low_structure_build`` (:208),
whose C++ (``native/boruvka.cpp``, ``native/tree_filter_host.cpp``) runs on
host threads. Here the same algorithm is four kernels in
``csrc/tree_filter.cu`` (CUDA C++ for sm_90a, built by ``ops/_build.py``,
bound with ctypes):

- ``tree_mst`` (K1): Boruvka MST selection of 4-connected grids under the
  order (weight, edge index), from the weights ``losses/tree_energy.py``
  ``mst_edge_weights`` gives; equal to ``ops/mst.py`` ``boruvka_mst``.
- ``tree_root`` (K2): a BFS from vertex 0 over the selected edges, in
  ``root_tree``'s queue order, and the filter weights in that order:
  ``BFSTree``.
- ``tree_filter_fwd`` (K3): upward A[v] = x[v] + sum_children w_c A[c],
  downward F[v] = A[v](1 - w_v^2) + w_v F[parent], on [x, 1]; y = F_x / F_1.
- ``tree_filter_bwd`` (K4): the same passes on [g/z, g y/z] give dx; for a
  high tree, the crossing-pair edge gradient gives d embed. It computes in
  float64 and rounds dx and d embed once: on the last tree of a chain d
  embed is ~1e-3 of the terms it is the difference of.

Each is a few CUDA kernels. K1: Boruvka rounds in shared memory, one block
a tile of the grid (a component hooks only across the tile's own edges),
then, one block an image, rounds on the graph of the components the tiles
leave, each round dropping the edges inside one component. K2: each vertex's selected edges
as a 4-bit mask on all SMs, then the BFS one block an image with the masks
and the current and next level in shared memory, then the weights on all
SMs. K3 and K4: a fully parallel gather into queue order, the two passes
(one block an image streaming the queue through a window of shared memory,
tiles in by TMA loads and out by TMA stores, its consumer warps meeting at
a named barrier a level), and fully parallel kernels back to vertex order
(K4: with the edge gradient and d embed). Keywords pick an instance
(``tile`` for K1, ``ring`` for K2, ``window`` for the passes:
the tests' small ones run the paths the main ones take only on larger
inputs), and ``stamps`` takes ``%globaltimer`` around a kernel's phases.

Each wrapper takes its plain PyTorch twin for CPU tensors and launches its
kernel for CUDA tensors (or raises; there is no fallback). ``TreeFilter`` is
the filter's ``autograd.Function``: it saves the forward's A and F, where
the native code recomputes them. ``launches`` counts wrapper calls that
launched, one each.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import annotate
from ._build import load_library
from .mst import boruvka_mst, grid_edges

MAX_CLASSES = 4  # the filter kernels are instantiated for C = 1..4
MAX_EMBED = 8
MAX_CHILDREN = 4  # the root's; every other vertex has at most 3
# the passes' windows built by csrc/tree_filter.cu (TILE x TILES, SMALL_TILE x SMALL_TILES)
WINDOW = 2048
SMALL_WINDOW = 64
# K1's tiles and K2's BFS rings built by csrc/tree_filter.cu (the main path's, the tests')
MST_TILE, SMALL_MST_TILE = 32, 8
RING, SMALL_RING = 2048, 16

launches = {"tree_mst": 0, "tree_root": 0, "tree_fwd": 0, "tree_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class BFSTree(NamedTuple):
    """Trees rooted at vertex 0 in BFS queue order, int32 / float32 on one device.

    order [N, V]     queue position -> vertex
    parent [N, V]    parent vertex, by vertex (the root's is 0)
    ppos [N, V]      the parent's queue position (the root's is 0)
    cptr [N, V + 1]  children of position q: positions cptr[q] .. cptr[q+1]-1
    level [N, V + 1] level L: positions level[L] .. level[L+1]-1
    n_levels [N]     number of levels (BFS depth + 1)
    w [N, V]         filter weight to the parent, in queue order (root: 0)
    """

    order: torch.Tensor
    parent: torch.Tensor
    ppos: torch.Tensor
    cptr: torch.Tensor
    level: torch.Tensor
    n_levels: torch.Tensor
    w: torch.Tensor

    def images(self, lo: int, hi: int) -> "BFSTree":
        return BFSTree(*(t[lo:hi] for t in self))


def inv_sigma(sigma: float) -> float:
    """1/sigma rounded as the native code rounds it (``1.f / sigma`` in fp32)."""
    return float(np.float32(1.0) / np.float32(sigma))


def num_grid_edges(height: int, width: int) -> int:
    return (height - 1) * width + height * (width - 1)


# ---- the plain twins -------------------------------------------------------


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[b, idx[b, i]] for t [B, V, C] and idx [B, ...] (int64)."""
    flat = idx.reshape(idx.shape[0], -1)
    out = t.gather(1, flat[..., None].expand(-1, -1, t.shape[-1]))
    return out.reshape(*idx.shape, t.shape[-1])


def _to_vertex_order(t_q: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows in queue order back to vertex order."""
    out = torch.empty_like(t_q)
    return out.scatter_(1, order[..., None].expand(-1, -1, t_q.shape[-1]), t_q)


def tree_mst_plain(weights: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """K1's twin: ``ops/mst.py`` ``boruvka_mst`` over the grid's edges."""
    eu, ev = (torch.as_tensor(a, device=weights.device) for a in grid_edges(height, width))
    return boruvka_mst(eu, ev, weights, height * width)


@torch.no_grad()
def tree_root_plain(selected: torch.Tensor, embed: torch.Tensor, height: int, width: int,
                    n_low: int, sigma: float) -> BFSTree:
    """K2's twin: the same BFS, level by level over all images on tensors.

    A level's vertices take their children in ``root_tree``'s order (right,
    left, down, up: decreasing edge index) and place them after the queue's
    end by a running count, so the queue, parents, parent positions, child
    ranges and level offsets are the kernel's. The weights use the kernel's
    rounding: the squared distance as fused multiply-adds in channel order
    (each formed in float64 from an exact product, then rounded to fp32),
    times 1/sigma.
    """
    dev = selected.device
    n, n_edges = selected.shape
    V, W = height * width, width
    HE = (height - 1) * width
    dump = V + 1  # a column that absorbs writes of padding entries
    sel = torch.cat([selected.bool(), selected.new_zeros((n, 1), dtype=torch.bool)], 1)
    order = torch.zeros((n, V + 2), dtype=torch.long, device=dev)
    parent = torch.zeros_like(order)
    ppos = torch.zeros_like(order)
    cptr = torch.zeros_like(order)
    level = torch.zeros_like(order)
    level[:, 1] = 1
    start = torch.zeros(n, dtype=torch.long, device=dev)
    end = torch.ones_like(start)
    n_levels = torch.zeros_like(start)
    while True:
        width_l = end - start
        m = int(width_l.max())
        if m == 0:
            break
        k = torch.arange(m, device=dev)
        valid = k < width_l[:, None]
        pos = torch.where(valid, start[:, None] + k, dump)
        u = torch.where(valid, order.gather(1, pos), 0)
        pu = parent.gather(1, u)
        i, j = u // W, u % W
        row = HE + i * (W - 1)
        nbr = torch.stack([u + 1, u - 1, u + W, u - W], -1)
        inside = torch.stack([j + 1 < W, j > 0, i + 1 < height, i > 0], -1)
        edge = torch.where(inside, torch.stack([row + j, row + j - 1, u, u - W], -1), n_edges)
        has = (valid[..., None] & sel.gather(1, edge.reshape(n, -1)).reshape(n, m, 4)
               & (nbr != pu[..., None]))
        cnt = has.sum(-1)
        cptr.scatter_(1, pos, end[:, None] + cnt.cumsum(1) - cnt)
        flat = has.reshape(n, -1)
        child_pos = torch.where(flat, end[:, None] + flat.cumsum(1) - 1, dump)
        child = nbr.reshape(n, -1)
        order.scatter_(1, child_pos, child)
        ppos.scatter_(1, child_pos, pos[..., None].expand(n, m, 4).reshape(n, -1))
        parent.scatter_(1, torch.where(flat, child, dump), u[..., None].expand(n, m, 4).reshape(n, -1))
        nxt = end + cnt.sum(1)
        active = width_l > 0
        n_levels += active.long()
        grew = active & (nxt > end)
        level.scatter_(1, torch.where(grew, n_levels + 1, dump)[:, None], nxt[:, None])
        start = torch.where(active, end, start)
        end = torch.where(active, nxt, end)
    cptr[:, V] = V

    order, parent, ppos = order[:, :V], parent[:, :V], ppos[:, :V]
    D = embed.shape[-1]
    e_v = _rows(embed, order)
    e_p = _rows(embed, parent.gather(1, order))
    s = torch.zeros_like(e_v[..., 0])
    for d in range(D):
        df = (e_v[..., d] - e_p[..., d]).double()
        s = (df * df + s.double()).float()
    inv = torch.ones(n, dtype=embed.dtype, device=dev)
    inv[:n_low] = inv_sigma(sigma)
    w = torch.exp(-(s * inv[:, None]))
    w[:, 0] = 0.0
    i32 = torch.int32
    return BFSTree(order.to(i32), parent.to(i32), ppos.to(i32), cptr[:, :V + 1].to(i32),
                   level[:, :V + 1].to(i32), n_levels.to(i32), w)


def _level_rows(tree: BFSTree, L: int):
    """(positions, valid) of level L of every image: [B, m] int64 and bool,
    padding entries pointing at position 0; None where no image has one."""
    lv, nl = tree.level, tree.n_levels
    s = lv[:, L].long()
    e = torch.where(nl > L, lv[:, L + 1].long(), s)
    m = int((e - s).max())
    if m <= 0:
        return None
    k = torch.arange(m, device=s.device)
    valid = k < (e - s)[:, None]
    return torch.where(valid, s[:, None] + k, 0), valid


def two_pass_plain(vals: torch.Tensor, tree: BFSTree) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, F) of ``vals`` [B, V, CH] in queue order, a level at a time.

    The upward pass pulls each position's children last to first, as the
    kernel does (and as ``two_pass_ord_t`` pushes them); the downward pass
    reads the level above.
    """
    B, V, CH = vals.shape
    cptr, w, ppos = tree.cptr.long(), tree.w, tree.ppos.long()
    n_levels = int(tree.n_levels.max())
    A = torch.cat([vals, vals.new_zeros(B, 1, CH)], 1)  # row V absorbs padding
    dump = torch.full((B, 1), V, dtype=torch.long, device=vals.device)
    for L in reversed(range(n_levels)):
        rows = _level_rows(tree, L)
        if rows is None:
            continue
        pos, valid = rows
        c0, c1 = cptr.gather(1, pos), cptr.gather(1, pos + 1)
        acc = _rows(A, pos)
        for k in range(MAX_CHILDREN):
            r = c1 - 1 - k
            has = r >= c0
            r = torch.where(has, r, 0)
            acc = torch.where(has[..., None], acc + w.gather(1, r)[..., None] * _rows(A, r), acc)
        tgt = torch.where(valid, pos, dump)
        A.scatter_(1, tgt[..., None].expand(-1, -1, CH), acc)
    F = A.clone()
    for L in range(1, n_levels):
        rows = _level_rows(tree, L)
        if rows is None:
            continue
        pos, valid = rows
        wq = w.gather(1, pos)[..., None]
        f = _rows(A, pos) * (1.0 - wq * wq) + wq * _rows(F, ppos.gather(1, pos))
        tgt = torch.where(valid, pos, dump)
        F.scatter_(1, tgt[..., None].expand(-1, -1, CH), f)
    return A[:, :V], F[:, :V]


@torch.no_grad()
def tree_filter_fwd_plain(x: torch.Tensor, tree: BFSTree):
    """K3's twin: (A, F, y) for x [B, V, C] (vertex order), fp32."""
    order = tree.order.long()
    x_q = _rows(x, order)
    A, F = two_pass_plain(torch.cat([x_q, torch.ones_like(x_q[..., :1])], -1), tree)
    C = x.shape[-1]
    return A, F, _to_vertex_order(F[..., :C] / F[..., C:], order)


def edge_gradient_plain(A, F, Aa, Fa, tree: BFSTree) -> torch.Tensor:
    """dL/d dist of each vertex's edge to its parent in a high tree (w =
    exp(-dist)), in queue order [B, V]: the crossing-pair decomposition of
    ``filter_one`` (root: 0)."""
    C = Aa.shape[-1] // 2
    pq = tree.ppos.long()
    Fp, Fap = _rows(F, pq), _rows(Fa, pq)
    wv = tree.w[..., None]
    A_x, A_1, Aa_a, Aa_t = A[..., :C], A[..., C:], Aa[..., :C], Aa[..., C:]
    s1 = (Aa_a * (Fp[..., :C] - wv * A_x) + A_x * (Fap[..., :C] - wv * Aa_a)).sum(-1)
    s2 = (Aa_t * (Fp[..., C:] - wv * A_1) + A_1 * (Fap[..., C:] - wv * Aa_t)).sum(-1)
    dd = (s1 - s2) * -tree.w
    dd[:, 0] = 0.0
    return dd


@torch.no_grad()
def tree_filter_bwd_plain(g, y, A, F, tree: BFSTree, embed: Optional[torch.Tensor]):
    """K4's twin: (dx, d embed) from dL/dy ``g`` [B, V, C]; d embed is None
    when ``embed`` is (the low tree). In float64, as K4; fp32 out."""
    C = g.shape[-1]
    g, y, A, F = (t.double() for t in (g, y, A, F))
    tree = tree._replace(w=tree.w.double())
    order = tree.order.long()
    z = F[..., C:]
    g_q = _rows(g, order)
    Aa, Fa = two_pass_plain(torch.cat([g_q / z, g_q * _rows(y, order) / z], -1), tree)
    dx = _to_vertex_order(Fa[..., :C].contiguous(), order)
    if embed is None:
        return dx.float(), None
    dd = edge_gradient_plain(A, F, Aa, Fa, tree)
    embed = embed.double()
    e_q = _rows(embed, order)
    e_p = _rows(embed, tree.parent.long().gather(1, order))
    own = (dd * 2.0)[..., None] * (e_q - e_p)  # this vertex's edge, to its own embedding
    cptr = tree.cptr.long()
    c0, c1 = cptr[:, :-1], cptr[:, 1:]
    acc = own
    for k in range(MAX_CHILDREN):  # each child's edge, with the opposite sign
        r = c0 + k
        has = r < c1
        acc = torch.where(has[..., None], acc - _rows(own, torch.where(has, r, 0)), acc)
    return dx.float(), _to_vertex_order(acc, order).float()


# ---- the kernels ----------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("tree_filter")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tree_mst.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.tree_root.argtypes = [p, p, i, i, i, i, i, f] + [p] * 9 + [i, p]
    lib.tree_filter_fwd.argtypes = [p] * 15 + [i] * 4 + [p]
    lib.tree_filter_bwd.argtypes = [p] * 12 + [i] + [p] * 7 + [i] * 4 + [p]
    for fn in (lib.tree_filter_padded, lib.tree_root_mask_bytes):
        fn.argtypes = [i]
    lib.tree_filter_consumer_warps.argtypes = []
    lib.tree_mst_tile_attributes.argtypes = [p]
    for fn in (lib.tree_mst, lib.tree_root, lib.tree_filter_fwd, lib.tree_filter_bwd,
               lib.tree_filter_padded, lib.tree_filter_consumer_warps, lib.tree_root_mask_bytes,
               lib.tree_mst_tile_attributes):
        fn.restype = i
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} tensor, got "
                         f"{tuple(t.shape)} (contiguous: {t.is_contiguous()})")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def _check_tree(tree: BFSTree, B: int, V: int, device) -> None:
    for name in ("order", "parent", "ppos"):
        _check(f"tree.{name}", getattr(tree, name), torch.int32, (B, V))
    for name in ("cptr", "level"):
        _check(f"tree.{name}", getattr(tree, name), torch.int32, (B, V + 1))
    _check("tree.n_levels", tree.n_levels, torch.int32, (B,))
    _check("tree.w", tree.w, torch.float32, (B, V))
    if tree.order.device != device:
        raise ValueError(f"tree on {tree.order.device}, tensors on {device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_out(name: str, t: Optional[torch.Tensor], dtype: torch.dtype, shape: tuple,
               device) -> Optional[int]:
    """An optional output a kernel fills (stamps, counts): its pointer or None."""
    if t is None:
        return None
    _check(name, t, dtype, shape)
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, tensors on {device}")
    return t.data_ptr()


def tree_mst_cuda(weights: torch.Tensor, height: int, width: int, *, tile: int = MST_TILE,
                  counts: Optional[torch.Tensor] = None,
                  stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: the MST of each grid, bool [N, E], from fp32 weights >= 0 [N, E].

    ``tile`` picks the instance (``MST_TILE``, or ``SMALL_MST_TILE``, whose
    contracted graph leaves shared memory early). ``counts`` (int32
    [N, 5]) gets each image's phase-1 rounds, the components and edges phase
    1 left, phase 2's rounds and those of them on device memory; ``stamps``
    (int64 [N, 4]) the %globaltimer ns of phase 1's first start and last end
    over the image's tiles and of phase 2's start and end."""
    n = weights.shape[0] if weights.ndim == 2 else 0
    E = num_grid_edges(height, width)
    _check("weights", weights, torch.float32, (n, E))
    if n < 1:
        raise ValueError("weights must hold at least one image")
    if tile not in (MST_TILE, SMALL_MST_TILE):
        raise ValueError(f"no MST instance with {tile}-vertex tiles: "
                         f"{MST_TILE} or {SMALL_MST_TILE}")
    V, dev = height * width, weights.device
    count_ptr = _check_out("counts", counts, torch.int32, (n, 5), dev)
    stamp_ptr = _check_out("stamps", stamps, torch.int64, (n, 4), dev)
    sel = torch.empty(weights.shape, dtype=torch.bool, device=dev)
    lab = torch.empty((n, V), dtype=torch.int32, device=dev)
    keys = torch.empty((n, E), dtype=torch.int64, device=dev)
    uv = torch.empty((n, E, 2), dtype=torch.int32, device=dev)
    best = torch.empty((n, V), dtype=torch.int64, device=dev)
    hook = torch.empty((n, V), dtype=torch.int32, device=dev)
    counters = torch.empty((2, n), dtype=torch.int32, device=dev)
    err = _lib().tree_mst(weights.data_ptr(), sel.data_ptr(), lab.data_ptr(), keys.data_ptr(),
                          uv.data_ptr(), best.data_ptr(), hook.data_ptr(), counters.data_ptr(),
                          count_ptr, stamp_ptr, n, height, width, tile, _stream(weights))
    _raise_on(err, "tree_mst")
    launches["tree_mst"] += 1
    return sel


def tree_root_cuda(selected: torch.Tensor, embed: torch.Tensor, height: int, width: int,
                   n_low: int, sigma: float, *, ring: int = RING,
                   stamps: Optional[torch.Tensor] = None) -> BFSTree:
    """K2: each image's tree rooted at vertex 0, with its filter weights
    (1/sigma on the first ``n_low`` images, 1 on the rest).

    ``ring`` picks the BFS instance: ``RING``, or ``SMALL_RING``, whose
    levels outgrow its ring and which reads the masks from device memory.
    ``stamps`` (int64 [N, 2]) gets the %globaltimer ns at each image's BFS
    start and end."""
    n, V = selected.shape[0], height * width
    _check("selected", selected, torch.bool, (n, num_grid_edges(height, width)))
    D = embed.shape[-1] if embed.ndim == 3 else 0
    _check("embed", embed, torch.float32, (n, V, D))
    if not 1 <= D <= MAX_EMBED:
        raise ValueError(f"kernel takes 1..{MAX_EMBED} embedding channels, got {D}")
    if selected.device != embed.device:
        raise ValueError(f"selected on {selected.device} but embed on {embed.device}")
    if ring not in (RING, SMALL_RING):
        raise ValueError(f"no BFS instance with a {ring}-entry ring: {RING} or {SMALL_RING}")
    dev = selected.device
    stamp_ptr = _check_out("stamps", stamps, torch.int64, (n, 2), dev)
    masks = torch.empty((n, _lib().tree_root_mask_bytes(V)), dtype=torch.uint8, device=dev)
    order, parent, ppos = (torch.empty((n, V), dtype=torch.int32, device=dev) for _ in range(3))
    cptr, level = (torch.empty((n, V + 1), dtype=torch.int32, device=dev) for _ in range(2))
    n_levels = torch.empty(n, dtype=torch.int32, device=dev)
    w = torch.empty((n, V), dtype=torch.float32, device=dev)
    err = _lib().tree_root(
        selected.data_ptr(), embed.data_ptr(), D, n, height, width, n_low, inv_sigma(sigma),
        masks.data_ptr(), order.data_ptr(), parent.data_ptr(), ppos.data_ptr(), cptr.data_ptr(),
        level.data_ptr(), n_levels.data_ptr(), w.data_ptr(), stamp_ptr, ring, _stream(selected))
    _raise_on(err, "tree_root")
    launches["tree_root"] += 1
    return BFSTree(order, parent, ppos, cptr, level, n_levels, w)


def mst_tile_registers() -> Tuple[int, int]:
    """K1's phase-1 kernel at ``MST_TILE`` as built: registers a thread and
    local-memory bytes a thread (register spills)."""
    out = (ctypes.c_int * 2)()
    _raise_on(_lib().tree_mst_tile_attributes(out), "tree_mst_tile_attributes")
    return out[0], out[1]


def _tree_ptrs(tree: BFSTree):
    return [t.data_ptr() for t in tree]


def _check_passes(window: int, stamps: Optional[torch.Tensor], B: int, device) -> None:
    """The passes' instance exists; ``stamps`` (optional) is int64 [B, 3] on
    the tensors' card: %globaltimer ns at a block's start, between its
    passes and at its end."""
    if window not in (WINDOW, SMALL_WINDOW):
        raise ValueError(f"no passes instance with a {window}-position window: "
                         f"{WINDOW} or {SMALL_WINDOW}")
    if stamps is not None:
        _check("stamps", stamps, torch.int64, (B, 3))
        if stamps.device != device:
            raise ValueError(f"stamps on {stamps.device}, tensors on {device}")


def _padded(V: int) -> int:
    """Positions an image of the filters' padded scratch."""
    return _lib().tree_filter_padded(V)


def consumer_warps() -> int:
    """The passes kernel's consumer warps (built into csrc/tree_filter.cu)."""
    return _lib().tree_filter_consumer_warps()


def tree_filter_fwd_cuda(x: torch.Tensor, tree: BFSTree, *, window: int = WINDOW,
                         stamps: Optional[torch.Tensor] = None):
    """K3: (A, F, y) for fp32 x [B, V, C] (vertex order) over ``tree``."""
    B, V, C = x.shape if x.ndim == 3 else (0, 0, 0)
    _check("x", x, torch.float32, (B, V, C))
    if not 1 <= C <= MAX_CLASSES:
        raise ValueError(f"kernel takes 1..{MAX_CLASSES} channels, got {C}")
    _check_tree(tree, B, V, x.device)
    _check_passes(window, stamps, B, x.device)
    A = torch.empty((B, V, C + 1), dtype=torch.float32, device=x.device)
    F = torch.empty_like(A)
    y = torch.empty_like(x)
    Vp = _padded(V)
    data = torch.empty((B, Vp, C + 1), dtype=torch.float32, device=x.device)
    fdata = torch.empty_like(data)
    meta = torch.empty((B, Vp, 4), dtype=torch.int32, device=x.device)
    err = _lib().tree_filter_fwd(
        x.data_ptr(), *_tree_ptrs(tree), A.data_ptr(), F.data_ptr(), y.data_ptr(),
        data.data_ptr(), fdata.data_ptr(), meta.data_ptr(),
        None if stamps is None else stamps.data_ptr(), B, V, C, window, _stream(x))
    _raise_on(err, "tree_filter_fwd")
    launches["tree_fwd"] += 1
    return A, F, y


def tree_filter_bwd_cuda(g, y, A, F, tree: BFSTree, embed: Optional[torch.Tensor], *,
                         window: int = WINDOW, stamps: Optional[torch.Tensor] = None):
    """K4: (dx, d embed) from fp32 dL/dy ``g`` [B, V, C]; d embed is None when
    ``embed`` is (the low tree)."""
    B, V, C = g.shape if g.ndim == 3 else (0, 0, 0)
    _check("g", g, torch.float32, (B, V, C))
    _check("y", y, torch.float32, (B, V, C))
    _check("A", A, torch.float32, (B, V, C + 1))
    _check("F", F, torch.float32, (B, V, C + 1))
    if not 1 <= C <= MAX_CLASSES:
        raise ValueError(f"kernel takes 1..{MAX_CLASSES} channels, got {C}")
    _check_tree(tree, B, V, g.device)
    _check_passes(window, stamps, B, g.device)
    D = 0
    if embed is not None:
        D = embed.shape[-1] if embed.ndim == 3 else 0
        _check("embed", embed, torch.float32, (B, V, D))
        if not 1 <= D <= MAX_EMBED:
            raise ValueError(f"kernel takes 1..{MAX_EMBED} embedding channels, got {D}")
    dev = g.device
    Aa = torch.empty((B, _padded(V), 2 * C), dtype=torch.float64, device=dev)
    Fa = torch.empty_like(Aa)
    meta = torch.empty((B, Aa.shape[1], 4), dtype=torch.int32, device=dev)
    dx = torch.empty_like(g)
    dd = torch.empty((B, V), dtype=torch.float64, device=dev) if embed is not None else None
    dembed = torch.empty_like(embed) if embed is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _lib().tree_filter_bwd(
        g.data_ptr(), y.data_ptr(), A.data_ptr(), F.data_ptr(), *_tree_ptrs(tree),
        ptr(embed), D, Aa.data_ptr(), Fa.data_ptr(), ptr(dd), meta.data_ptr(), dx.data_ptr(),
        ptr(dembed), ptr(stamps), B, V, C, window, _stream(g))
    _raise_on(err, "tree_filter_bwd")
    launches["tree_bwd"] += 1
    return dx, dembed


# ---- dispatch --------------------------------------------------------------


def tree_mst(weights: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """MST masks [N, E]: the twin for CPU tensors, K1 for CUDA tensors."""
    if weights.device.type == "cpu":
        return tree_mst_plain(weights, height, width)
    return tree_mst_cuda(weights, height, width)


def tree_root(selected: torch.Tensor, embed: torch.Tensor, height: int, width: int,
              n_low: int, sigma: float) -> BFSTree:
    """``BFSTree`` of each image: the twin for CPU tensors, K2 for CUDA tensors."""
    if selected.device.type == "cpu" and embed.device.type == "cpu":
        return tree_root_plain(selected, embed, height, width, n_low, sigma)
    return tree_root_cuda(selected, embed, height, width, n_low, sigma)


class TreeFilter(torch.autograd.Function):
    """y = F_x / F_1 over a ``BFSTree``; gradients to the feature and, for a
    high tree, to its guide ``embed``.

    A bf16 feature (the softmax of bf16 logits under AMP) is widened to fp32
    on entry, so y is fp32; each gradient comes back in its input's dtype.
    """

    @staticmethod
    def forward(ctx, feature, embed, tree: BFSTree, low_tree: bool):
        ctx.dtypes = (feature.dtype, embed.dtype)
        x = feature.float().contiguous()
        fwd = tree_filter_fwd_plain if x.device.type == "cpu" else tree_filter_fwd_cuda
        A, F, y = fwd(x, tree)
        ctx.tree, ctx.low_tree = tree, low_tree
        ctx.save_for_backward(embed, y, A, F)
        return y

    @staticmethod
    def backward(ctx, g):
        with annotate("fedicra.tree.filter_backward"):
            embed, y, A, F = ctx.saved_tensors
            emb = None if ctx.low_tree else embed.float().contiguous()
            g = g.float().contiguous()
            bwd = tree_filter_bwd_plain if g.device.type == "cpu" else tree_filter_bwd_cuda
            dx, dembed = bwd(g, y, A, F, ctx.tree, emb)
            dembed = None if dembed is None else dembed.to(ctx.dtypes[1])
            return dx.to(ctx.dtypes[0]), dembed, None, None


def tree_filter(feature: torch.Tensor, embed: torch.Tensor, tree: BFSTree, *,
                low_tree: bool = True) -> torch.Tensor:
    """Filter ``feature`` [B, V, C] over ``tree`` (vertex order in and out).

    ``tree``'s weights were formed from ``embed`` [B, V, D] by ``tree_root``:
    exp(-||d||^2 / sigma) on the low tree, whose guide gets no gradient, and
    exp(-||d||^2) on a high tree, whose guide gets one.
    """
    return TreeFilter.apply(feature, embed.detach() if low_tree else embed, tree, low_tree)
