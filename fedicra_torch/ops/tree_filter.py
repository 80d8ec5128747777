"""The learnable tree filter as dense O(V log V) primitives, in PyTorch ops.

Counterpart of ``fedicra_tpu/ops/tree_filter.py`` (XLA ops there, no Pallas
kernel; PyTorch ops here), batched over images: ``x`` is [B, V, C] in DFS
order and ``logw``, ``parent_pos``, ``size`` are [B, V].

With edge weight w_i = exp(logw_i) from node i to its parent (the root's
forced to 0), M[i, j] = the product of w along the tree path i..j, and the
filter is y = (M x) / (M 1).

Upward pass, A[v] = sum_{u in subtree(v)} W(u, v) x_u: a contiguous DFS
range sum of x_u P[u], divided by P[v] (P = root-path weight product), by
parent pointer doubling for log P and a max-stabilised sparse table.
Downward pass, F[v] = A[v] (1 - w_v^2) + w_v F[parent]: affine-map binary
lifting. ``tree_filter_refine`` is an ``autograd.Function`` whose backward
is the JAX custom VJP: dx = M (g / z), and dlogw from the saved aggregates.
"""

from __future__ import annotations

import torch

from .mst import ceil_log2
from .tree import TreeStructure

# forward and backward runs of ``TreeFilterRefine``
calls = {"tree_filter_fwd": 0, "tree_filter_bwd": 0}


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


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
        calls["tree_filter_fwd"] += 1
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
        calls["tree_filter_bwd"] += 1
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
