"""Batched Boruvka minimum spanning tree of 4-connected grids, in PyTorch ops.

Counterpart of ``fedicra_tpu/ops/mst.py``, which writes the MST as XLA
gathers and scatter-min with no Pallas kernel; here it is PyTorch ops on
whatever device the weights are on.

Batching: the B images form one graph of B*V vertices. Edge e of image b is
global edge b*E + e with endpoints b*V + eu[e] and b*V + ev[e], so the
within-image edge order, and with it the (weight, edge index) tie-break, is
kept. Components never cross images, so ceil_log2(V) rounds of hooking and
ceil_log2(V) pointer jumps per round suffice, as for one image. The
selection is bit-identical to the JAX function's and to ``mst_oracle``'s.
"""

from __future__ import annotations

import math
from typing import Tuple

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


def mst_oracle(eu: np.ndarray, ev: np.ndarray, ew: np.ndarray, V: int) -> np.ndarray:
    """Numpy Kruskal with (weight, index) tie-break; the oracle for ``boruvka_mst``."""
    order = np.lexsort((np.arange(len(ew)), ew))
    parent = np.arange(V)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    sel = np.zeros(len(ew), dtype=bool)
    cnt = 0
    for i in order:
        ru, rv = find(int(eu[i])), find(int(ev[i]))
        if ru != rv:
            parent[ru] = rv
            sel[i] = True
            cnt += 1
            if cnt == V - 1:
                break
    return sel
