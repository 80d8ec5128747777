"""Rooted-tree structure from MST edge masks, via a parallel Euler tour.

Counterpart of ``fedicra_tpu/ops/tree.py`` (XLA ops there, no Pallas
kernel; PyTorch ops here), batched over images: every array carries a
leading batch dimension and every sort, gather and scatter runs along the
last one, so images never mix.

1. Each of the V-1 tree edges becomes two arcs; arcs are grouped by source
   vertex with a stable sort.
2. Euler circuit successor: succ(u->v) = the arc after (v->u) in v's cyclic
   arc list.
3. The circuit is cut at the first arc out of the root (vertex 0) and
   list-ranked with Wyllie pointer doubling.
4. Arc ranks give each vertex its discovery and finish times, parent and
   subtree size; vertices sorted by discovery time give the DFS order, in
   which every subtree is a contiguous range.

The arrays equal the JAX function's exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .mst import ceil_log2


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
