#!/usr/bin/env python3
"""Kernel-alone times of the port's hand-written kernels at the main path's
shapes and the other tasks', beside their bounds, plain twins and library
yardsticks.

    python3 tools/kernel_times.py [group ...]

From the root of a checkout, on a machine with a CUDA card; it imports no
JAX. Prints one JSON line, {"device": ..., "rows": [...]}, a row a kernel at
a task's step shape: ``gated_crf``, ``gaussian_filter`` (the dense CRF's,
off the main path), ``tree_mst``, ``tree_root``, ``tree_fwd``, ``tree_bwd``,
``dsn_stats``, ``dsn_epilogue_forward`` and ``dsn_epilogue_backward`` at
ODOC's, ``<name>[faz]`` and ``<name>[polyp]`` at the other tasks'; named
groups (``ROW_GROUPS``: gated_crf, gaussian_filter, tree, dsn_stats,
dsn_epilogue) give their rows alone. Every row has ``ms`` (median of single timed calls, the
host's set-up inside the events), ``loop_ms`` (a call's share of calls
launched back to back: the device's time), ``plain_ms`` (the plain twin),
``library_ms`` (one library call that computes the same function, or
null), ``bound_ms`` and ``bound_by`` (the least time the card could take:
the function's operations at 67 TFLOP/s fp32 or its bytes at 3.35 TB/s,
whichever binds); the tree kernels' rows add what their counters and
%globaltimer stamps read. Card full fp32 (no TF32). It checks nothing: the
card tests (``-m cuda``) do.
"""

from __future__ import annotations

import copy
import functools
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor-core) op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TREE_NAMES = ("low", "high 4x", "high 2x", "high 1x")
MST_COUNTS = ("phase-1 rounds", "components left", "edges left", "phase-2 rounds",
              "of them on device memory")


def bound_ms(ops: float, nbytes: float):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops / FP32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gated_crf_work(b: int, c: int, nf: int, h: int, w: int, r: int):
    """(fp32 operations, exps) that the gated CRF's loss and acc need at least.

    k_o(q) = k_{-o}(q+o) when both pixels are inside, so each such unordered
    pair forms its difference and squared norm (3F, an FMA counting two) and
    its exp once; each ordered pair adds k to K and C FMAs to acc (2C + 1).
    A pixel with neighbours outside forms |f(q)|^2 (2F) and one exp, and adds
    their count times it to K (2). Each pixel takes K - <y, acc> and adds it
    to the sum (2C + 2). The exps run on the special-function units, not on
    the FP32 pipe, so they are returned apart.
    """
    inside = sum(max(h - abs(dy), 0) * max(w - abs(dx), 0)
                 for dy in range(-r, r + 1) for dx in range(-r, r + 1)) - h * w
    border = h * w - max(h - 2 * r, 0) * max(w - 2 * r, 0)
    ops = (inside // 2 * 3 * nf + inside * (2 * c + 1) + border * (2 * nf + 2)
           + h * w * (2 * c + 2))
    return b * ops, b * (inside // 2 + border)


def gaussian_filter_work(b: int, n: int, d: int, c: int):
    """(fp32 operations, exps) that the Gaussian filter needs at least.

    k(i, j) = k(j, i), so each pair i != j forms its exponent
    f_i.f_j - |f_i|^2/2 - |f_j|^2/2 from per-point norms (D FMAs and one add)
    and its exp once; every ordered pair, i = j included, takes C
    accumulating FMAs; each point forms its norm (D FMAs). An FMA counts two;
    the exps run on the special-function units and are returned apart.
    """
    pairs = n * (n - 1) // 2
    return b * (pairs * (2 * d + 1) + n * n * 2 * c + n * 2 * d), b * pairs


def dsn_stats_work(b: int, c: int, h: int, w: int, hidden: int = 512):
    """(fp32 operations, bytes) that a head's moments need at least: the
    patch Gram's distinct entries, multiply-adds of two operations. The Gram
    is block-Toeplitz: channels a and b's 9 x 9 block is made of their 25 lag
    correlations over the image (13 where a = b, by symmetry), less border
    rows and columns: per image 30 rows of W and 30 columns of H products a
    pair a != b (15 each where a = b). The input and the weight read once.
    The 512 quadratic forms in float64 are left out."""
    pairs = c * (c - 1) // 2
    per_pixel = 25 * pairs + 13 * c
    border = (30 * pairs + 15 * c) * (h + w)
    return 2 * b * (h * w * per_pixel + border), 4 * (b * c * h * w + hidden * (9 * c + 1))


# ---- timing ------------------------------------------------------------------


def cuda_median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device ms of single calls, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_loop_ms(fn, n: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Per-call device time of ``n`` calls launched back to back (median of
    ``reps`` runs), so host work between calls hides behind the queue."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()  # keeps the card busy while the first timed call is set up
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def row(name: str, ms: float, loop_ms: float, plain_ms: float, work, library_ms=None, **extra) -> dict:
    bound, by = bound_ms(*work)
    return dict(name=name, ms=ms, loop_ms=loop_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by=by, **extra)


# ---- the kernels -----------------------------------------------------------


def gated_crf_row(dev, task: str, suffix: str) -> dict:
    """The fused pass at the task's step shape (batch 12, its classes and
    side, F = 2 + its channels, r = 5) on the softmax of normal logits; also
    back to back without writing acc, and on bf16 y (AMP)."""
    from fedicra_torch.engine.config import TASKS
    from fedicra_torch.losses.gated_crf import gated_crf_features
    from fedicra_torch.ops import gated_crf_cuda as g
    from torch_card import BATCH, smooth_images

    t = TASKS[task]
    b, c, h, r = BATCH, t["num_classes"], t["img_size"], 5
    rng = np.random.default_rng(10)
    image = torch.as_tensor(smooth_images(rng, b, h, h, t["in_chns"]), device=dev)
    f = gated_crf_features(image, 6.0, 0.1).permute(0, 3, 1, 2).contiguous()
    y = torch.softmax(torch.as_tensor(rng.normal(size=(b, c, h, h)).astype(np.float32), device=dev),
                      1).contiguous()
    y16 = y.to(torch.bfloat16)
    ops, exps = gated_crf_work(b, c, f.shape[1], h, h, r)
    return row(f"gated_crf{suffix}", cuda_median_ms(lambda: g.gated_crf_fused_cuda(y, f, r)),
               cuda_loop_ms(lambda: g.gated_crf_fused_cuda(y, f, r)),
               cuda_median_ms(lambda: g.gated_crf_potts_fused_plain(y, f, r), reps=10),
               (ops, 4 * (2 * y.numel() + f.numel())),  # y and f read, acc written
               exps=exps,
               no_acc_loop_ms=cuda_loop_ms(lambda: g.gated_crf_fused_cuda(y, f, r, need_acc=False)),
               bf16_ms=cuda_median_ms(lambda: g.gated_crf_fused_cuda(y16, f, r)),
               bf16_loop_ms=cuda_loop_ms(lambda: g.gated_crf_fused_cuda(y16, f, r)))


def attention_filter(feats: torch.Tensor, values: torch.Tensor):
    """The filter by PyTorch's memory-efficient attention, the library
    yardstick (the port never calls it): softmax(q k^T) v with q = [f, 1] and
    k = [f, -|f|^2/2], scale 1, then times exp(lse - |f_i|^2/2).

    Returns (a function of no arguments computing it, its head width).
    Pads the head until the operator takes it; if no width does, raises."""
    b, n, d = feats.shape
    c = values.shape[2]
    half = 0.5 * (feats * feats).sum(-1)
    efficient = torch.ops.aten._scaled_dot_product_efficient_attention
    last = None
    for width in (8, 16, 32):
        zeros = feats.new_zeros(b, n, width - d - 1)
        q = torch.cat([feats, torch.ones_like(half)[..., None], zeros], -1)[:, None].contiguous()
        k = torch.cat([feats, -half[..., None], zeros], -1)[:, None].contiguous()
        v = torch.nn.functional.pad(values, (0, width - c))[:, None].contiguous()

        def run(q=q, k=k, v=v):
            o, lse = efficient(q, k, v, None, True, 0.0, False, scale=1.0)[:2]
            return o[:, 0, :, :c] * torch.exp(lse[:, 0, :n] - half)[..., None]

        try:
            run()
            torch.cuda.synchronize()
            return run, width
        except RuntimeError as err:  # a width the operator refuses: pad further
            last = err
    raise RuntimeError(f"memory-efficient attention refused widths 8, 16 and 32: {last}")


def gaussian_filter_row(dev) -> dict:
    """The dense CRF's filter at its shape beside ODOC's step (B = 12,
    N = 192^2, D = 5, C = 3), its inputs as ``dense_crf_loss`` forms them
    (scale factor 0.5); the library yardstick is memory-efficient
    attention."""
    from fedicra_torch.losses.tree_energy import resize_linear, resize_nearest
    from fedicra_torch.ops import gaussian_filter_cuda as gf
    from torch_card import dense_crf_inputs

    images, logits, rois = dense_crf_inputs(dev)
    b, h, w, c = logits.shape
    hw = (h // 2, w // 2)
    feats = gf.bilateral_features(resize_nearest(images * 255.0, hw), 15.0, 50.0).contiguous()
    seg = resize_linear(torch.softmax(logits, -1), hw) * resize_nearest(rois[..., None], hw)
    seg = seg.reshape(b, hw[0] * hw[1], c).contiguous()
    n, d = feats.shape[1:]
    run_lib, width = attention_filter(feats, seg)
    ops, exps = gaussian_filter_work(b, n, d, c)
    return row("gaussian_filter", cuda_median_ms(lambda: gf.gaussian_filter_cuda(feats, seg), reps=10, warmup=2),
               cuda_loop_ms(lambda: gf.gaussian_filter_cuda(feats, seg), n=10, reps=3, warmup=1),
               cuda_median_ms(lambda: gf.gaussian_filter_plain(feats, seg), reps=3, warmup=1),
               (ops, 4 * (feats.numel() + 2 * seg.numel())),
               library_ms=cuda_median_ms(run_lib, reps=10, warmup=2), exps=exps,
               library_loop_ms=cuda_loop_ms(run_lib, n=10, reps=3, warmup=1),
               library=f"aten._scaled_dot_product_efficient_attention, head width {width}")


def _by_tree(values: torch.Tensor, b: int):
    """(max, mean) of a per-image value over each tree's ``b`` images."""
    return [[values[k * b:(k + 1) * b].max().item(), values[k * b:(k + 1) * b].mean().item()]
            for k in range(values.shape[0] // b)]


def tree_rows(dev, task: str, suffix: str) -> list:
    """K1-K4 on one tree-on step's four trees at the task's shape (batch 12
    a tree; the low guide the task's image, a gray one repeated to 3
    channels; the high guides aux logits of its classes upsampled 4x, 2x
    and 1x), as the objective builds and filters them. The filter rows are
    the mean of the step's four launches, chained as the path chains them.
    Adds K1's counts by tree (max and mean over its images) and its phases'
    times, K2's BFS ns a level by tree, each filter pass's ns a level by
    tree (the kernels' stamps), and the BFS depth by tree."""
    from benchmark.harness.work import tree_chain_work
    from fedicra_torch.engine.config import TASKS
    from fedicra_torch.losses.tree_energy import mst_edge_weights, native_structures
    from fedicra_torch.ops import tree_filter_cuda as tfc
    from fedicra_torch.ops.mst import grid_edges
    from torch_card import BATCH, TREE_SIGMA, tree_guides

    t = TASKS[task]
    b, h, c = BATCH, t["img_size"], t["num_classes"]
    V, n = h * h, 4 * BATCH
    rng = np.random.default_rng(6)
    low, highs = tree_guides(dev, rng, b, h, h, c, channels=t["in_chns"])
    guides = [low, *highs]
    eu, ev = (torch.as_tensor(a, device=dev).long() for a in grid_edges(h, h))
    dist = mst_edge_weights(guides, eu, ev)
    sel = tfc.tree_mst_cuda(dist, h, h)
    flats = [gd.reshape(b, V, -1) for gd in guides]
    d = max(f.shape[-1] for f in flats)
    embed = torch.cat([torch.nn.functional.pad(f, (0, d - f.shape[-1])) for f in flats]).contiguous()
    trees = native_structures(guides, TREE_SIGMA)
    n_levels = torch.cat([tr.n_levels for tr in trees]).long().cpu()
    work = tree_chain_work(b, h, h, c, d, int((n_levels + 1).sum()))
    rows = []

    counts = torch.zeros((n, 5), dtype=torch.int32, device=dev)
    stamps = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    tfc.tree_mst_cuda(dist, h, h, counts=counts, stamps=stamps)
    torch.cuda.synchronize()
    cn, st = counts.cpu().double(), stamps.cpu().double()
    rows.append(row(f"tree_mst{suffix}", cuda_median_ms(lambda: tfc.tree_mst_cuda(dist, h, h), reps=10, warmup=2),
                    cuda_loop_ms(lambda: tfc.tree_mst_cuda(dist, h, h), n=10, reps=3),
                    cuda_median_ms(lambda: tfc.tree_mst_plain(dist, h, h), reps=3, warmup=1),
                    work["tree_mst"],
                    counts_by_tree={name: dict(zip(TREE_NAMES, _by_tree(cn[:, i], b)))
                                    for i, name in enumerate(MST_COUNTS)},
                    phase1_ms=(st[:, 1].max() - st[:, 0].min()).item() / 1e6,
                    to_phase2_ms=(st[:, 2].min() - st[:, 1].max()).item() / 1e6,
                    phase2_ms=(st[:, 3].max() - st[:, 2].min()).item() / 1e6,
                    registers_and_local_bytes=list(tfc.mst_tile_registers())))

    bfs = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    tfc.tree_root_cuda(sel, embed, h, h, b, TREE_SIGMA, stamps=bfs)
    torch.cuda.synchronize()
    bfs_ns = (bfs[:, 1] - bfs[:, 0]).cpu().double()
    root = functools.partial(tfc.tree_root_cuda, sel, embed, h, h, b, TREE_SIGMA)
    rows.append(row(f"tree_root{suffix}", cuda_median_ms(root, reps=10, warmup=2),
                    cuda_loop_ms(root, n=10, reps=3),
                    cuda_median_ms(lambda: tfc.tree_root_plain(sel, embed, h, h, b, TREE_SIGMA), reps=1, warmup=0),
                    work["tree_root"], depth_by_tree=dict(zip(TREE_NAMES, _by_tree(n_levels.double() - 1, b))),
                    bfs_ns_a_level_by_tree=dict(zip(TREE_NAMES, _by_tree(bfs_ns / n_levels.double(), b)))))

    x = torch.softmax(torch.as_tensor(rng.normal(size=(b, V, c)).astype(np.float32), device=dev), -1)
    g = torch.as_tensor(rng.normal(size=(b, V, c)).astype(np.float32), device=dev)
    fwd_args, saved, cur = [], [], x
    for tr in trees:
        fwd_args.append((cur, tr))
        A, F, cur = tfc.tree_filter_fwd_cuda(cur, tr)
        saved.append((cur, A, F))
    bwd_args, cur = [None] * 4, g
    for k in reversed(range(4)):
        e = None if k == 0 else highs[k - 1].reshape(b, V, c).contiguous()
        bwd_args[k] = (cur, *saved[k], trees[k], e)
        cur = tfc.tree_filter_bwd_cuda(*bwd_args[k])[0]
    for name, kernel, plain, args in (("tree_fwd", tfc.tree_filter_fwd_cuda, tfc.tree_filter_fwd_plain, fwd_args),
                                      ("tree_bwd", tfc.tree_filter_bwd_cuda, tfc.tree_filter_bwd_plain, bwd_args)):
        four = lambda: [kernel(*a) for a in args]  # noqa: E731
        passes = {}
        for k, a in enumerate(args):
            stamps = torch.zeros((b, 3), dtype=torch.int64, device=dev)
            kernel(*a, stamps=stamps)
            torch.cuda.synchronize()
            s = stamps.cpu().double()
            levels = n_levels[k * b:(k + 1) * b].double()
            passes[TREE_NAMES[k]] = {"up": ((s[:, 1] - s[:, 0]) / levels).mean().item(),
                                     "down": ((s[:, 2] - s[:, 1]) / levels).mean().item()}
        rows.append(row(f"{name}{suffix}", cuda_median_ms(four, reps=10, warmup=2) / 4,
                        cuda_loop_ms(four, n=10, reps=3) / 4,
                        statistics.mean(cuda_median_ms(lambda a=a: plain(*a), reps=1, warmup=0) for a in args),
                        work[name], pass_ns_a_level_by_tree=passes, consumer_warps=tfc.consumer_warps()))
    return rows


def dsn_stats_row(dev, task: str, suffix: str) -> dict:
    """The moments kernels of a contrast forward's three DSN heads at the
    task's shapes (batch 12), summed over the heads; the library
    composition is cuDNN's convolution, then ``torch.batch_norm_stats``."""
    from fedicra_torch.ops import dsn_stats_cuda as dsn
    from torch_card import BATCH, DSN_HEAD_SHAPES, dsn_head_inputs

    tot = dict(ms=0.0, loop=0.0, plain=0.0, library=0.0, ops=0.0, bytes=0.0)
    by_head = []
    for c, side in DSN_HEAD_SHAPES[task]:
        x, w, b = dsn_head_inputs(dev, c, side)
        head = dict(ms=cuda_median_ms(lambda: dsn.conv3x3_batch_moments(x, w, b)),
                    loop=cuda_loop_ms(lambda: dsn.conv3x3_batch_moments(x, w, b)),
                    plain=cuda_median_ms(lambda: dsn.conv3x3_batch_moments_plain(x, w, b), reps=5),
                    library=cuda_median_ms(lambda: torch.batch_norm_stats(
                        torch.nn.functional.conv2d(x, w, b, padding=1), 1e-5)))
        head["ops"], head["bytes"] = dsn_stats_work(BATCH, c, side, side)
        by_head.append(head["loop"])
        for k in tot:
            tot[k] += head[k]
    return row(f"dsn_stats{suffix}", tot["ms"], tot["loop"], tot["plain"], (tot["ops"], tot["bytes"]),
               library_ms=tot["library"], loop_ms_by_head=by_head)


def dsn_epilogue_rows(dev, task: str, suffix: str) -> list:
    """The epilogue kernels of a step's three DSN heads at the task's shapes
    (batch 12, 512 channels, its classes, p = 0.1), summed over the heads:
    the train-mode forward (the statistics pass and the chain's pass; its
    eval-mode forward, the chain's pass alone, beside it) and the backward
    (pass A with its sums, then pass B; pass A alone beside it). The plain
    twin is the PyTorch composition the kernels replaced (cuDNN's batch norm
    and 1x1 convolution, ReLU and the mask's products), also the library
    yardstick. The bound is bytes: y (and g) read once, aux (and dy)
    written once; ``floor_ms`` is the design's own bytes: y read twice each
    way."""
    from fedicra_torch.engine.config import TASKS
    from fedicra_torch.ops import dsn_epilogue_cuda as epi
    from torch_card import BATCH, DSN_HEAD_SHAPES, DSN_HIDDEN, dsn_epilogue_inputs

    k, p = TASKS[task]["num_classes"], 0.1
    keys = ("ms", "loop", "plain", "alone_loop", "bytes", "floor")
    tot = {way: dict.fromkeys(keys, 0.0) for way in ("forward", "backward")}
    for _, side in DSN_HEAD_SHAPES[task]:
        (y, weight, keep, g), bn = dsn_epilogue_inputs(BATCH, DSN_HIDDEN, side, side, k, p, "train", dev)
        plane, out = 4 * y.numel(), 4 * g.numel()
        fwd = {"ms": lambda: epi.dsn_epilogue(y, bn, weight, keep, p),
               "plain": lambda: epi.dsn_epilogue_plain(y, bn, weight, keep, p)}
        eval_bn = copy.deepcopy(bn).eval()
        with torch.no_grad():
            head = tot["forward"]
            head["ms"] += cuda_median_ms(fwd["ms"])
            head["loop"] += cuda_loop_ms(fwd["ms"])
            head["plain"] += cuda_median_ms(fwd["plain"])
            head["alone_loop"] += cuda_loop_ms(lambda: epi.dsn_epilogue(y, eval_bn, weight, None, p))
        head["bytes"] += plane + out
        head["floor"] += 2 * plane + out
        leaves = [y.requires_grad_(), bn.weight, bn.bias, weight.requires_grad_()]
        graphs = {route: fn(y, bn, weight, keep, p)
                  for route, fn in (("ms", epi.dsn_epilogue), ("plain", epi.dsn_epilogue_plain))}
        back = {route: (lambda aux=aux: torch.autograd.grad(aux, leaves, g, retain_graph=True))
                for route, aux in graphs.items()}
        head = tot["backward"]
        head["ms"] += cuda_median_ms(back["ms"])
        head["loop"] += cuda_loop_ms(back["ms"])
        head["plain"] += cuda_median_ms(back["plain"])
        del graphs, back
        aux = epi.dsn_epilogue(y.detach(), bn, weight, keep, p)  # pass A alone: no gradient for y
        head["alone_loop"] += cuda_loop_ms(lambda: torch.autograd.grad(aux, leaves[1:], g, retain_graph=True))
        head["bytes"] += 2 * plane + out
        head["floor"] += 3 * plane + out
        del aux, y, g
        torch.cuda.empty_cache()
    rows = []
    for way, alone in (("forward", "eval_loop_ms"), ("backward", "pass_a_loop_ms")):
        t = tot[way]
        rows.append(row(f"dsn_epilogue_{way}{suffix}", t["ms"], t["loop"], t["plain"], (0.0, t["bytes"]),
                        library_ms=t["plain"], floor_ms=bound_ms(0.0, t["floor"])[0], **{alone: t["alone_loop"]}))
    return rows


ROW_GROUPS = ("gated_crf", "gaussian_filter", "tree", "dsn_stats", "dsn_epilogue")


def main(argv=None) -> int:
    """Every row, or the rows of the groups named on the command line
    (``ROW_GROUPS``)."""
    groups = set(sys.argv[1:] if argv is None else argv) or set(ROW_GROUPS)
    if groups - set(ROW_GROUPS):
        print(f"kernel_times: groups are {', '.join(ROW_GROUPS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from torch_card import full_fp32

    full_fp32()
    dev = torch.device("cuda")
    plan = [("gated_crf", lambda: [gated_crf_row(dev, "odoc", "")]),
            ("gaussian_filter", lambda: [gaussian_filter_row(dev)]),
            ("tree", lambda: tree_rows(dev, "odoc", "")),
            ("dsn_stats", lambda: [dsn_stats_row(dev, "odoc", ""), dsn_stats_row(dev, "faz", "[faz]")]),
            ("dsn_epilogue", lambda: dsn_epilogue_rows(dev, "odoc", "") + dsn_epilogue_rows(dev, "faz", "[faz]"))]
    plan += [(group, fn) for task in ("faz", "polyp")
             for group, fn in (("gated_crf", lambda t=task: [gated_crf_row(dev, t, f"[{t}]")]),
                               ("tree", lambda t=task: tree_rows(dev, t, f"[{t}]")))]
    rows = []
    for group, fn in plan:
        if group in groups:
            torch.cuda.empty_cache()
            rows += fn()
    print(json.dumps({"device": {"name": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count(), "torch": torch.__version__},
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
