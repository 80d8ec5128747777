"""The tree chain in plain PyTorch: a frozen copy of the port's plain twins.

Copied from ``fedicra_torch/ops/mst.py`` (Boruvka MST of the 4-connected
grid, (weight, edge index) order), ``ops/tree.py`` (rooting at vertex 0 by
an Euler tour, DFS order) and ``ops/tree_filter.py`` (the normalised tree
filter y = (M x) / (M 1) by pointer doubling, and its analytic VJP), so
that the yardstick stays fixed while the program changes. The benchmark's
reference runs the filter in float64: the float32 doubling drifts by
~1e-4 on trees thousands of levels deep.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


def grid_edges(height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """4-connected grid edge list: vertical edges then horizontal edges."""
    idx = np.arange(height * width, dtype=np.int32).reshape(height, width)
    eu = np.concatenate([idx[:-1, :].reshape(-1), idx[:, :-1].reshape(-1)])
    ev = np.concatenate([idx[1:, :].reshape(-1), idx[:, 1:].reshape(-1)])
    return eu, ev


def ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def boruvka_mst(eu: torch.Tensor, ev: torch.Tensor, ew: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """Select MST edges of each image; returns a bool mask shaped like ``ew``.

    eu, ev: integer [E] endpoints shared by every image; ew: float [E] or
    [B, E] weights. Each graph must be connected (a grid always is), so
    exactly V-1 edges are selected per image.
    """
    single = ew.ndim == 1
    ew = ew.reshape(-1, ew.shape[-1])
    nb, n_edges = ew.shape
    V = num_vertices
    dev = ew.device
    N, M = nb * V, nb * n_edges
    offsets = torch.arange(nb, device=dev)[:, None]
    gu = (offsets * V + eu.to(dev).long()).reshape(-1)
    gv = (offsets * V + ev.to(dev).long()).reshape(-1)
    w = ew.reshape(-1)
    edge_idx = torch.arange(M, device=dev)
    arange_v = torch.arange(N, device=dev)
    inf = torch.full((N,), math.inf, dtype=w.dtype, device=dev)
    no_edge = torch.full((N,), M, dtype=torch.long, device=dev)

    comp = arange_v
    selected = torch.zeros(M + 1, dtype=torch.bool, device=dev)  # slot M: dropped
    for _ in range(ceil_log2(V)):
        cu, cv = comp[gu], comp[gv]
        active = cu != cv
        w_act = torch.where(active, w, math.inf)
        # segment-min of weight per component (each edge posts to both sides)
        min_w = inf.scatter_reduce(0, cu, w_act, "amin").scatter_reduce(0, cv, w_act, "amin")
        # among weight-minimal edges, the smallest edge index
        cand_u = torch.where(active & (w_act == min_w[cu]), edge_idx, M)
        cand_v = torch.where(active & (w_act == min_w[cv]), edge_idx, M)
        best = no_edge.scatter_reduce(0, cu, cand_u, "amin").scatter_reduce(0, cv, cand_v, "amin")
        has = best < M
        selected[best] = True
        best_c = best.clamp(max=M - 1)

        # hook each component to the component across its best edge
        bu, bv = comp[gu[best_c]], comp[gv[best_c]]
        other = torch.where(bu == arange_v, bv, bu)
        parent = torch.where(has, other, arange_v)
        # break mutual pairs deterministically: the smaller id becomes the root
        mutual = parent[parent] == arange_v
        parent = torch.where(mutual & (arange_v < parent), arange_v, parent)
        for _ in range(ceil_log2(V)):
            parent = parent[parent]
        comp = parent[comp]
    selected = selected[:M].reshape(nb, n_edges)
    return selected[0] if single else selected



class TreeStructure(NamedTuple):
    """Rooted trees in DFS indexing, all arrays [B, V] (int64).

    dfs_vertices[b, i] = original vertex id at DFS position i
    dfs_pos[b, v]      = DFS position of original vertex v
    parent_pos[b, i]   = DFS position of the parent of the node at position i
                         (the root points to itself)
    size[b, i]         = subtree size of the node at DFS position i
    """

    dfs_vertices: torch.Tensor
    dfs_pos: torch.Tensor
    parent_pos: torch.Tensor
    size: torch.Tensor


def _scatter_dropped(shape_bv, fill, index, src, dev):
    """out[b, index[b, a]] = src[b, a], where index V means "drop"."""
    nb, V = shape_bv
    out = torch.full((nb, V + 1), fill, dtype=torch.long, device=dev)
    return out.scatter_(1, index, src)[:, :V]


def build_tree(eu: torch.Tensor, ev: torch.Tensor, selected: torch.Tensor, num_vertices: int) -> TreeStructure:
    """Root each image's selected spanning tree at vertex 0 (``selected`` [B, E])."""
    dev = selected.device
    nb, n_edges = selected.shape
    V = num_vertices
    A = 2 * n_edges
    arange_a = torch.arange(A, device=dev).expand(nb, A)
    eu, ev = eu.to(dev).long(), ev.to(dev).long()

    # arc 2i = (u->v), arc 2i+1 = (v->u)
    arc_src = torch.stack([eu, ev], dim=1).reshape(-1).expand(nb, A)
    arc_dst = torch.stack([ev, eu], dim=1).reshape(-1).expand(nb, A)
    act = selected.repeat_interleave(2, dim=1)

    # group active arcs by source vertex (stable => by arc id within a group)
    sortkey = torch.where(act, arc_src, V)
    order = torch.argsort(sortkey, dim=1, stable=True)  # sorted pos -> arc
    rank = torch.empty_like(order).scatter_(1, order, arange_a)  # arc -> sorted pos

    deg = torch.zeros((nb, V), dtype=torch.long, device=dev).scatter_add_(1, arc_src, act.long())
    group_start = torch.cumsum(deg, dim=1) - deg

    # next arc (cyclically) within the source group
    gs = group_start.gather(1, arc_src)
    d = deg.gather(1, arc_src).clamp(min=1)
    next_in_group = order.gather(1, gs + torch.remainder(rank - gs + 1, d))

    # Euler successor: succ(u->v) = next arc after (v->u) around v
    twin = arange_a ^ 1
    succ = next_in_group.gather(1, twin)

    # cut the circuit at the first arc out of the root (vertex 0)
    start_arc = order.gather(1, group_start[:, :1])
    pred = torch.zeros((nb, A + 1), dtype=torch.long, device=dev)
    pred = pred.scatter_(1, torch.where(act, succ, A), arange_a)[:, :A]
    last_arc = pred.gather(1, start_arc)

    # Wyllie list ranking: dist[a] = number of steps from a to last_arc
    is_last = arange_a == last_arc
    nxt = torch.where(is_last, arange_a, succ)
    dist = (~is_last).long()
    for _ in range(ceil_log2(A) + 1):
        dist = dist + dist.gather(1, nxt)
        nxt = nxt.gather(1, nxt)
    n_arcs = 2 * (V - 1)
    pos = (n_arcs - 1) - dist  # position of each arc in the Euler sequence
    pos_twin = pos.gather(1, twin)

    # discovery arcs: the first traversal of each edge
    down_dst = torch.where(act & (pos < pos_twin), arc_dst, V)
    parent = _scatter_dropped((nb, V), 0, down_dst, arc_src, dev)
    in_time = _scatter_dropped((nb, V), -1, down_dst, pos, dev)
    out_time = _scatter_dropped((nb, V), n_arcs, down_dst, pos_twin, dev)

    size = (out_time - in_time + 1) // 2
    size[:, 0] = V

    dfs_vertices = torch.argsort(in_time, dim=1, stable=True)
    arange_v = torch.arange(V, device=dev).expand(nb, V)
    dfs_pos = torch.empty_like(dfs_vertices).scatter_(1, dfs_vertices, arange_v)
    parent_pos = dfs_pos.gather(1, parent.gather(1, dfs_vertices))
    parent_pos[:, 0] = 0  # root self-loop
    return TreeStructure(
        dfs_vertices=dfs_vertices,
        dfs_pos=dfs_pos,
        parent_pos=parent_pos,
        size=size.gather(1, dfs_vertices),
    )

def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[b, idx[b, i]] for t [B, V] or [B, V, C] and idx [B, V]."""
    if t.ndim == 2:
        return t.gather(1, idx)
    return t.gather(1, idx[..., None].expand(-1, -1, t.shape[-1]))


def _log_path_products(logw: torch.Tensor, parent_pos: torch.Tensor) -> torch.Tensor:
    """logP[b, i] = sum of logw along the path root..i (root entries must be 0)."""
    lp, anc = logw, parent_pos
    for _ in range(ceil_log2(logw.shape[1])):
        lp = lp + lp.gather(1, anc)
        anc = anc.gather(1, anc)
    return lp


def _shift_left(t: torch.Tensor, half: int, fill: float) -> torch.Tensor:
    """t[:, i + half], or ``fill`` past the end."""
    pad = t.new_full((t.shape[0], half) + t.shape[2:], fill)
    return torch.cat([t[:, half:], pad], dim=1)


def _subtree_range_sums(vals: torch.Tensor, logp: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """A[b, i] = sum_{j in [i, i+size_i)} vals[b, j] exp(logp[b, j] - logp[b, i]).

    Level k of the table holds (m, s) for [i, i + 2^k): a shared exponent m
    and a significand s, so the sums stay exact to fp precision where the
    path products underflow.
    """
    nb, V, C = vals.shape
    K = ceil_log2(V)
    t_m = logp.new_empty((K + 1, nb, V))
    t_s = vals.new_empty((K + 1, nb, V, C))
    t_m[0], t_s[0] = logp, vals
    for k in range(K):
        m_prev, s_prev = t_m[k], t_s[k]
        half = 1 << k
        m2 = _shift_left(m_prev, half, -torch.inf)
        s2 = _shift_left(s_prev, half, 0.0)
        m = torch.maximum(m_prev, m2)
        e1 = torch.exp(m_prev - m)
        e2 = torch.where(torch.isfinite(m2), torch.exp(m2 - m), 0.0)
        t_m[k + 1] = m
        t_s[k + 1] = s_prev * e1[..., None] + s2 * e2[..., None]
    t_m = t_m.reshape(-1)  # level k, image b, node i at (k * B + b) * V + i
    t_s = t_s.reshape(-1, C)

    # greedy binary decomposition of each interval [i, i + size_i)
    acc_m = torch.full_like(logp, -torch.inf)
    acc_s = torch.zeros_like(vals)
    row = torch.arange(nb, device=vals.device)[:, None] * V
    cur = torch.arange(V, device=vals.device).expand(nb, V)
    rem = size
    for _ in range(K + 1):
        valid = rem > 0
        # floor(log2(rem)): frexp's exponent is exact for integers below 2^24
        k = torch.frexp(rem.clamp(min=1).float())[1].long() - 1
        lin = (k * nb * V + row + cur.clamp(max=V - 1)).reshape(-1)
        seg_m = t_m[lin].reshape(nb, V)
        seg_s = t_s[lin].reshape(nb, V, C)
        m = torch.maximum(acc_m, seg_m)
        e_acc = torch.where(torch.isfinite(acc_m), torch.exp(acc_m - m), 0.0)
        e_seg = torch.where(torch.isfinite(seg_m), torch.exp(seg_m - m), 0.0)
        s = acc_s * e_acc[..., None] + seg_s * e_seg[..., None]
        take = torch.bitwise_left_shift(torch.ones_like(k), k)
        acc_m = torch.where(valid, m, acc_m)
        acc_s = torch.where(valid[..., None], s, acc_s)
        cur = torch.where(valid, cur + take, cur)
        rem = torch.where(valid, rem - take, rem)
    return acc_s * torch.exp(acc_m - logp)[..., None]


def _downward(a_coef: torch.Tensor, b_add: torch.Tensor, parent_pos: torch.Tensor) -> torch.Tensor:
    """Solve F[i] = b[i] + a[i] F[parent(i)] (the root has a = 0) by lifting."""
    anc, a, b = parent_pos, a_coef, b_add
    for _ in range(ceil_log2(a_coef.shape[1])):
        b = b + a[..., None] * _gather_rows(b, anc)
        a = a * a.gather(1, anc)
        anc = anc.gather(1, anc)
    return b


def _root_zeroed(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    t[:, 0] = 0.0
    return t


def _edge_weights(logw: torch.Tensor) -> torch.Tensor:
    """w = exp(logw) with every image's root entry 0."""
    return _root_zeroed(torch.exp(_root_zeroed(logw)))


def _filter_core(x, logw, parent_pos, size):
    """(A, F): upward aggregates and the unnormalised filter of x [B, V, C]."""
    logp = _log_path_products(_root_zeroed(logw), parent_pos)
    A = _subtree_range_sums(x, logp, size)
    w = _edge_weights(logw)
    c = A * (1.0 - w * w)[..., None]
    c[:, 0] = A[:, 0]
    return A, _downward(w, c, parent_pos)


class TreeFilterRefine(torch.autograd.Function):
    """y = (M x) / (M 1) over DFS-ordered nodes; gradients to x and logw.

    A bf16 ``x`` (the softmax of bf16 logits under AMP) is widened to
    ``logw``'s fp32 on entry, so y is fp32, the type JAX's promotion gives
    the filter's sums; each gradient comes back in its input's dtype.
    """

    @staticmethod
    def forward(ctx, x, logw, parent_pos, size):
        ctx.x_dtype = x.dtype
        x = x.to(logw.dtype)
        C = x.shape[-1]
        xs = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        A, F = _filter_core(xs, logw, parent_pos, size)
        A_x, A_1, F_x, F_1 = A[..., :C], A[..., C:], F[..., :C], F[..., C:]
        y = F_x / F_1
        ctx.save_for_backward(logw, parent_pos, size, A_x, A_1, F_x, F_1, y)
        return y

    @staticmethod
    def backward(ctx, g):
        logw, parent_pos, size, A_x, A_1, F_x, F_1, y = ctx.saved_tensors
        C = y.shape[-1]
        a = g / F_1  # dL/d(unnormalised filtered x)
        t = g * y / F_1  # feeds the normaliser's gradient
        A_at, F_at = _filter_core(torch.cat([a, t], dim=-1), logw, parent_pos, size)
        A_a, A_t, F_a, F_t = A_at[..., :C], A_at[..., C:], F_at[..., :C], F_at[..., C:]
        dx = F_a  # M (g / z)
        dlogw = None
        if ctx.needs_input_grad[1]:
            w = _edge_weights(logw)
            wc = w[..., None]
            p = parent_pos
            s1 = torch.sum(A_a * (_gather_rows(F_x, p) - wc * A_x)
                           + A_x * (_gather_rows(F_a, p) - wc * A_a), dim=-1)
            s2 = torch.sum(A_t * (_gather_rows(F_1, p) - wc * A_1)
                           + A_1 * (_gather_rows(F_t, p) - wc * A_t), dim=-1)
            dlogw = _root_zeroed(w * (s1 - s2))
        return dx.to(ctx.x_dtype), dlogw, None, None


def tree_filter_refine(x, logw, parent_pos, size):
    """Normalised tree filter of x [B, V, C] (DFS order) with [B, V] trees."""
    return TreeFilterRefine.apply(x, logw, parent_pos, size)


def tree_filter(
    feature: torch.Tensor,
    embed: torch.Tensor,
    struct: TreeStructure,
    *,
    sigma: float = 0.02,
    low_tree: bool = True,
) -> torch.Tensor:
    """Filter ``feature`` [B, V, C] over the trees, guided by ``embed`` [B, V, D].

    Both are in original vertex order. The edge weight between a node and
    its parent is exp(-||d||^2 / sigma) for the low-level tree, whose
    weights get no gradient, and exp(-||d||^2) for high-level trees, whose
    weights pass the gradient on to ``embed``.
    """
    embed_dfs = _gather_rows(embed, struct.dfs_vertices)
    dist = torch.sum((embed_dfs - _gather_rows(embed_dfs, struct.parent_pos)) ** 2, dim=-1)
    logw = (-dist / sigma).detach() if low_tree else -dist
    x_dfs = _gather_rows(feature, struct.dfs_vertices)
    y_dfs = tree_filter_refine(x_dfs, logw, struct.parent_pos, struct.size)
    return _gather_rows(y_dfs, struct.dfs_pos)


# --- the multi-scale recursive tree energy ("MScaleRecurve"), written here


def _edge_distances(guide: torch.Tensor, eu: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
    """MST edge weights ||d guide||^2 + 1 of [B, V, D] guides over the grid's edges."""
    return torch.sum((guide[:, eu] - guide[:, ev]) ** 2, dim=-1) + 1.0


def tree_depths(struct: TreeStructure) -> torch.Tensor:
    """Each image's tree depth (edges from the root to its deepest vertex), [B]."""
    depth = (torch.arange(struct.parent_pos.shape[1], device=struct.parent_pos.device) > 0).long()
    depth = depth.expand_as(struct.parent_pos)
    anc = struct.parent_pos
    for _ in range(ceil_log2(anc.shape[1]) + 1):
        depth = depth + depth.gather(1, anc)
        anc = anc.gather(1, anc)
    return depth.amax(dim=1)


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` with half-pixel centres (upsampling)."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    out = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                                          align_corners=False)
    return out.permute(0, 2, 3, 1)


def multi_scale_tree_energy(logits: torch.Tensor, guide: torch.Tensor, aux, rois: torch.Tensor,
                            weight: float, sigma: float = 0.02, stats: dict = None) -> torch.Tensor:
    """weight * sum(ROI |p - AS_3|) / sum(ROI), NHWC: p = softmax(logits);
    AS = the low tree's filter of p, guided by the image (exp(-||d||^2 /
    sigma), no gradient); AS_k = the k-th high tree's filter of AS_{k-1},
    guided by aux logit k upsampled to the logits' size (exp(-||d||^2), its
    gradient to aux). Each tree is the guide's MST rooted at vertex 0. The
    filters run in float64; the loss returns in float32. ``stats``, if
    given, receives each tree's depths (``depths``: [4, B])."""
    b, h, w, c = logits.shape
    V = h * w
    prob = torch.softmax(logits, dim=-1)
    highs = [resize_bilinear(a, (h, w)) for a in aux]
    guides = [guide.detach().reshape(b, V, -1)] + [g.reshape(b, V, -1) for g in highs]
    eu, ev = (torch.as_tensor(a, device=logits.device).long() for a in grid_edges(h, w))
    with torch.no_grad():
        dist = torch.cat([_edge_distances(g.detach(), eu, ev) for g in guides])
        struct = build_tree(eu, ev, boruvka_mst(eu, ev, dist, V), V)
    trees = [TreeStructure(*(t[k * b:(k + 1) * b] for t in struct)) for k in range(4)]
    if stats is not None:
        stats["depths"] = torch.stack([tree_depths(t) for t in trees])
    cur = prob.reshape(b, V, c).double()
    for k, (g, tree) in enumerate(zip(guides, trees)):
        cur = tree_filter(cur, g.double(), tree, sigma=sigma, low_tree=(k == 0))
    rois = rois.to(prob.dtype)[..., None]
    n = rois.sum()
    l1 = torch.sum(rois.double() * torch.abs(prob.reshape(b, h, w, c).double() - cur.reshape(b, h, w, c)))
    loss = torch.where(n > 0, l1 / n.clamp(min=1.0), l1)
    return (weight * loss).float()
