#!/usr/bin/env python3
"""Drive the PyTorch port (fedicra_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. build every CUDA source under fedicra_torch/csrc for sm_90a (one nvcc
   per source, in parallel);
2. the fused gated-CRF kernel (loss and acc in one pass) against its plain
   PyTorch twin at the main-path shape (B=12, C=3, 384x384, radius 5), on
   the present inputs and on confident ones, with times and bound;
3. the Gaussian-filter kernel against its twin at the dense-CRF shape beside
   the headline config (B=12, N=192^2, D=5, C=3), value and VJP, and against
   float64 direct sums on 256 rows of each image, with times per call and
   back to back, bound, and the library yardstick (memory-efficient
   attention, timed only); then the dense-CRF loss path: one forward and backward at that
   shape on the card (its launches counted), and the loss on the card
   against the CPU at a small input;
4. the tree-energy chain's plain route (``[tree-plain]``, PyTorch ops, off
   the main path on the card) at the main-path shape: MST, Euler tour and
   the DFS-ordered filter's forward and backward, each timed per call; one
   image's MST and tree on the card against the same on the CPU, from the
   same weights;
4b. the tree chain's four kernels (``[tree-kernels]``, csrc/tree_filter.cu)
   against their plain twins at the main-path shape, one step's four trees
   (48 images): the MST bit for bit against ``boruvka_mst``, the BFS rooting
   exactly and its weights at rtol 1e-6, the filter's forward (rtol 1e-4)
   and backward (rtol 1e-3) and the same filter against the plain route's
   on the same trees; each kernel timed per call and back to back beside its
   twin and bound; the MST's counts by tree (phase-1 rounds, the components
   and edges phase 1 leaves, phase-2 rounds) and its phases' times, the
   slowest phase 2 of the images whose contracted graph starts on device
   memory, and its phase-1 kernel's registers and local memory (within
   their budget); the BFS's time
   and ns a level by tree (its %globaltimer stamps); each tree's BFS depth
   and widest level; each filter pass's time and ns a level by tree (the passes
   kernel's stamps, with the passes' consumer-warp count); on a
   path-shaped tree the MST and the BFS (against the path's arrays, and
   the twin on a 64 x 64 path) and each pass's ns a level;
4c. the DSN heads' moment kernels (``[dsn-stats]``, csrc/dsn_stats.cu) at
   the six head shapes (ODOC's three at 384^2, FAZ's at 256^2, batch 12):
   mean and variance against float64 direct statistics and the plain twin
   at rtol 1e-5, the running buffers against the twin's, each head timed
   per call and back to back beside its bound, the twin and the library
   composition (cuDNN's conv, then ``torch.batch_norm_stats``);
5. the "ours" objective (tree term on) and ``treeenergy_add`` on the card
   (the kernel route) against the CPU (the plain route) at a small input,
   the CPU's trees built from the card's MST weights, and where the trees
   of each device's own weights differ;
6. the tree-off round: one FedICRA local round of "ours" at
   tree_loss_weight=0, full-width unet_lc_multihead for ODOC (384^2, batch
   12, 5 clients, real dropout rates), 1 head step then 1 body step;
7. the main path: the same round at the default tree_loss_weight=0.1,
   2 head steps then 2 body steps, its tree term on the kernels (4 MST, 4
   rooting, 16 forward and 16 backward filter launches, no plain filter
   run; 3 DSN moment launches in each of a step's 4 contrast forwards),
   its first step again on the plain route (``loss_tree`` at rtol
   1e-4); then one ``treeenergy_add`` step at that shape;
8. the federation: build_experiment and FederatedServer.run for 2 rounds
   of FedICRA "ours" at the same width, 5 clients on synthetic ODOC data,
   ALA's first-run loop in round 2, the evaluation, checkpoints and a
   resume (``phase_federation``), then one FedAdam round of 2 clients x 1
   step against FedAdam's update in float64;
8b. the SPMD federation (``[sharded]``): 8's run on the (1, 1) mesh,
   its losses against 8's; the mesh (1, 2) as two gloo ranks on the card,
   batch 6 each, the first step's loss and BatchNorm statistics against
   (1, 1)'s; (2, 1) over NCCL when there are two cards;
9. the user's entry points, in-process in a temporary directory
   (``phase_cli``): the federated train CLI (1 round of "ours" at the same
   width), the test CLI's loader, inference, CSVs and PNGs on phase 8's
   snapshot,
   the centralized ``unet`` baseline at 256^2 (again inside a profiler
   trace), and the runner at its own defaults (FAZ, ``unet``, FedAvg, pCE);
10. the main path under mixed precision (``[main-amp]``, after 7): the same
   round with ``amp=True``, its gated-CRF launches on bf16 probabilities, the
   dtypes of one step's forward and BatchNorm inputs, and its first loss
   against 7's (2 also checks the kernel's bf16 entry against an fp32 launch
   on the widened input, bit for bit);
11. the last two model types through the train CLI (``[models]``): ``pnet``
   under ``--amp 1`` and ``efficient_unet`` under ``--amp 1`` with a B3
   ``--encoder_weights`` file, 1 round of 5 full-width ODOC clients, pCE;
12. the runner's ``--distributed`` route (``[distributed]``): 9's route-1
   round with 1 server and 5 client processes on the card over TCP, its
   losses against route 1's, each process's peak memory;
13. the permutohedral-lattice dense CRF (``[lattice]``, host C++) at 3's
   shape against the exact loss from the Gaussian-filter kernel, timed;
14. ensemble uncertainty (``[uncertainty]``): full-width
   ``unet_lc_multihead`` at 12 x 384^2, T = 8, timed, against the CPU;
15. the full gated-CRF surface (``[gated-crf-surface]``, plain PyTorch):
   tied to the CUDA kernel through an all-ones ``mask_dst``, masks,
   compatibility and two kernels against the CPU, forward and backward
   timed;
16. the paper's other two tasks (``[tasks]``, ``phase_tasks``): FAZ (256^2,
   1 channel, 2 classes, 5 clients) and Polyp (384^2, 3 channels, 2
   classes, 4 clients), each at batch 12 and full width: the gated-CRF
   kernel (F = 3 and 5) and the tree chain's four kernels (FAZ's low guide
   one gray channel) against their twins at the task's step shape, timed
   beside their bounds; a 4-step round of "ours" at tree_loss_weight 0.1
   (launches 4 / 4 / 4 / 16 / 16, no plain filter, the first loss_tree
   against the plain route's); 2 federated rounds of the task's synthetic
   clients with ALA's first run and the evaluation.

Each path (3's loss, 6, 7 and its treeenergy_add step, 8 and its FedAdam
round, 8b's (1, 1) run and each of its ranks, each route of 9 and 11, 10,
and each task's round and federation in 16) runs with the launch counters
set to 0 just before it and read just after; each that trains "ours"
shows the tree kernels' launches (one MST and one rooting launch, four
filter forwards and four backwards a step) and no run of the plain
route's filter. 13-15 launch
a kernel of the port only as the reference they are compared with (13 the
Gaussian filter, 15 the gated CRF); 12's processes launch the gated-CRF
kernel, which their CUDA tensors cannot bypass, and this process cannot
count. The last lines are the card's name and power limit, one JSON line
of per-kernel numbers (the gated CRF, the Gaussian filter, the four
tree kernels and the DSN moments at the main path's shape, the DSN moments
at FAZ's (``dsn_stats[faz]``, launches not counted), then the gated CRF and the tree
kernels at each task's, named ``gated_crf[faz]`` and so on, their
launches the task's round's), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor-core) op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the headline configuration: ODOC at 384^2, batch 12
BATCH, IMG = 12, 384
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(ops: float, nbytes: float):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops / FP32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cuda_median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()  # keeps the card busy while the first timed call is set up
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


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


def phase_build():
    from fedicra_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {len(_build.sources())} source(s) built in {time.perf_counter() - t0:.2f} s")
    # ptxas -v: per kernel, its (mangled) name, then its spills, then its registers and shared memory
    for text in reports.values():
        kernel, spills = "?", ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                log(f"[build] {kernel}: {line.split(':', 1)[1].strip()}; {spills}")


def smooth_images(rng, b: int, h: int, w: int, channels: int = 3) -> np.ndarray:
    """(b, h, w, channels) images in [0, 1] that vary slowly, dark at the
    top-left (3 channels: ODOC's and Polyp's rgb; 1: FAZ's gray).

    The gated CRF's guide is rgb/0.1, so on per-pixel noise nearly every
    neighbour weight k_o is ~0. Slow waves keep k_o spread over (0, 1), and
    the dark corner keeps the zero-padded border terms there from vanishing.
    """
    v = np.linspace(0.0, 1.0, h)[:, None, None]
    u = np.linspace(0.0, 1.0, w)[None, :, None]
    freq = rng.uniform(1.0, 3.0, size=(b, 1, 1, channels, 2))
    phase = rng.uniform(0.0, 2 * np.pi, size=(b, 1, 1, channels))
    wave = np.sin(2 * np.pi * (freq[..., 0] * u + freq[..., 1] * v) + phase)
    img = u * v * (0.6 + 0.3 * wave) + 0.005 * rng.normal(size=(b, h, w, channels))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def confident_logits(rng, b: int, c: int, h: int, w: int) -> np.ndarray:
    """(b, c, h, w) logits, 20x a one-hot map of smooth class regions (the
    argmax of slow waves) plus a little noise: their softmax is near one-hot
    with sharp borders, where K(q) and <y(q), acc(q)> are close and large and
    their difference is what the loss keeps."""
    v = np.linspace(0.0, 1.0, h)[:, None]
    u = np.linspace(0.0, 1.0, w)[None, :]
    freq = rng.uniform(1.0, 2.0, size=(b, c, 1, 1, 2))
    phase = rng.uniform(0.0, 2 * np.pi, size=(b, c, 1, 1))
    waves = np.sin(2 * np.pi * (freq[..., 0] * u + freq[..., 1] * v) + phase)
    regions = np.moveaxis(np.eye(c)[waves.argmax(axis=1)], -1, 1)
    return (20.0 * (regions + 0.05 * rng.normal(size=(b, c, h, w)))).astype(np.float32)


def gated_crf_inputs(dev, rng, b: int, c: int, h: int, w: int, channels: int = 3):
    """The fused kernel's inputs at a step's shape: the features [x, y,
    image] of smooth images of ``channels`` channels (F = 2 + channels), and
    two probability maps, the softmax of normal logits ("present") and near
    one-hot maps ("confident"). Returns (f, {tag: y})."""
    from fedicra_torch.losses.gated_crf import gated_crf_features

    logits = rng.normal(size=(b, c, h, w)).astype(np.float32)
    image = torch.as_tensor(smooth_images(rng, b, h, w, channels), device=dev)
    f = gated_crf_features(image, 6.0, 0.1).permute(0, 3, 1, 2).contiguous()
    inputs = {
        "present": torch.softmax(torch.as_tensor(logits, device=dev), 1).contiguous(),
        "confident": torch.softmax(torch.as_tensor(confident_logits(rng, b, c, h, w), device=dev),
                                   1).contiguous(),
    }
    return f, inputs


def hold_gated_crf(prefix: str, tag: str, y, f, r: int):
    """The fused kernel against its twins on one input: the same bits on a
    second launch and without acc, the loss at rtol 1e-5 against the fused
    and the pairwise twin and float64, acc at rtol 1e-4 / atol 1e-6; through
    autograd one launch in the forward and none in the backward, whose dy is
    -2/(B H W) acc. Returns (loss |diff|, acc max |diff|)."""
    from fedicra_torch.ops import gated_crf_cuda as g

    b, _, h, w = y.shape
    denom = b * h * w
    loss_k, acc_k = g.gated_crf_fused_cuda(y, f, r)
    loss_k2, _ = g.gated_crf_fused_cuda(y, f, r)
    loss_n, acc_n = g.gated_crf_fused_cuda(y, f, r, need_acc=False)
    loss_p, acc_p = g.gated_crf_potts_fused_plain(y, f, r)
    loss_pair = g.gated_crf_potts_plain(y, f, r)
    loss_64, _ = g.gated_crf_potts_fused_plain(y.double(), f.double(), r)
    torch.cuda.synchronize()
    if not (torch.equal(loss_k, loss_k2) and torch.equal(loss_k, loss_n)) or acc_n is not None:
        raise AssertionError(f"gated_crf ({tag}): runs on the same input differ")
    loss_err = abs(loss_k.item() - loss_p.item())
    acc_err = (acc_k - acc_p).abs().max().item()
    # sum_c acc(q) = sum of k_o(q) over q's neighbours inside the image
    mean_k = acc_p.sum(dim=1).mean().item() / ((2 * r + 1) ** 2 - 1)
    log(f"{prefix} {tag}: loss kernel {loss_k.item():.9g} twin {loss_p.item():.9g} "
        f"pairwise twin {loss_pair.item():.9g} float64 twin {loss_64.item():.9g}; "
        f"acc max |kernel - twin| {acc_err:.3g} (max acc {acc_p.abs().max().item():.4g}, "
        f"mean k over pairs {mean_k:.4g})")
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(loss_k, loss_pair, rtol=1e-5, atol=0)
    if not math.isclose(loss_k.item(), loss_64.item(), rel_tol=1e-5):
        raise AssertionError(f"gated_crf ({tag}): kernel {loss_k.item()!r} vs float64 {loss_64.item()!r}")
    # dL/dy = -2/(B H W) acc is ~1e-6 here, so an atol of 1e-6 on it would
    # pass nearly anything: hold the kernel's unscaled acc(q) to the twin's.
    torch.testing.assert_close(acc_k, acc_p, rtol=1e-4, atol=1e-6)

    # the autograd route: one launch in the forward, none in the backward
    y_auto = y.clone().requires_grad_(True)
    g.reset_launches()
    loss_a = g.gated_crf_potts(y_auto, f, r)
    n_fwd = g.launches["gated_crf"]
    loss_a.backward()
    torch.cuda.synchronize()
    if (n_fwd, g.launches["gated_crf"]) != (1, 1):
        raise AssertionError(f"gated_crf ({tag}): launches {n_fwd} in the forward, "
                             f"{g.launches['gated_crf'] - n_fwd} in the backward")
    torch.testing.assert_close(y_auto.grad * (-denom / 2.0), acc_p, rtol=1e-4, atol=1e-6)
    return loss_err, acc_err


def phase_gated_crf(dev):
    """The fused kernel vs its plain twin at B=12, C=3, 384^2, r=5, on the
    present inputs and on confident ones, with times and bound; returns the
    JSON row (its launches are the main path's)."""
    from fedicra_torch.ops import gated_crf_cuda as g

    b, c, h, w, r = BATCH, 3, IMG, IMG, 5
    f, inputs = gated_crf_inputs(dev, np.random.default_rng(0), b, c, h, w)
    nf = f.shape[1]
    denom = b * h * w

    errs = []
    for tag, y in inputs.items():
        errs += hold_gated_crf("[gated_crf]", tag, y, f, r)

    # the bf16 entry (AMP): a launch on bf16 y gives the loss and acc of an
    # fp32 launch on the widened y bit for bit; dy is the fp32 dy rounded
    for tag, y in inputs.items():
        y16 = y.to(torch.bfloat16)
        loss16, acc16 = g.gated_crf_fused_cuda(y16, f, r)
        loss32, acc32 = g.gated_crf_fused_cuda(y16.float(), f, r)
        if not (torch.equal(loss16, loss32) and torch.equal(acc16, acc32)):
            raise AssertionError(f"gated_crf bf16 ({tag}): loss or acc differs from the fp32 launch "
                                 f"on the widened input ({loss16.item()!r} vs {loss32.item()!r})")
        y_b = y16.clone().requires_grad_(True)
        y_f = y16.float().requires_grad_(True)
        g.reset_launches()
        g.gated_crf_potts(y_b, f, r).backward()
        by_dtype = dict(g.launches_by_dtype)
        g.gated_crf_potts(y_f, f, r).backward()
        torch.cuda.synchronize()
        if by_dtype != {"float32": 0, "bfloat16": 1} or g.launches["gated_crf"] != 2:
            raise AssertionError(f"gated_crf bf16 ({tag}): launches {by_dtype}, {g.launches}")
        if y_b.grad.dtype != torch.bfloat16 or not torch.equal(y_b.grad, y_f.grad.to(torch.bfloat16)):
            raise AssertionError(f"gated_crf bf16 ({tag}): dy is not the fp32 dy rounded to bf16")
        log(f"[gated_crf] bf16 entry ({tag}): loss {loss16.item():.9g} equals the fp32 launch on "
            f"the widened input bit for bit, acc too; dy bf16 equals the fp32 dy rounded")
        del acc16, acc32, y_b, y_f

    # Every row's ms is a median of single timed calls, host set-up inside the
    # events, as the earlier design's 0.51 + 0.54 ms were taken; back to back
    # the host set-up hides behind the queue, which is the device's time.
    y = inputs["present"]
    y16 = y.to(torch.bfloat16)
    call16_ms = cuda_median_ms(lambda: g.gated_crf_fused_cuda(y16, f, r))
    loop16_ms = cuda_loop_ms(lambda: g.gated_crf_fused_cuda(y16, f, r))
    log(f"[gated_crf] bf16 entry: fused pass {call16_ms:.4f} ms per call, {loop16_ms:.4f} ms back to "
        f"back (y read as bf16: {2 * y.numel()} bytes instead of {4 * y.numel()})")
    cot = torch.ones((), device=dev)
    _, acc = g.gated_crf_fused_cuda(y, f, r)
    call_ms = cuda_median_ms(lambda: g.gated_crf_fused_cuda(y, f, r))
    scale_ms = cuda_median_ms(lambda: acc * (cot * (-2.0 / denom)))
    loop_ms = cuda_loop_ms(lambda: g.gated_crf_fused_cuda(y, f, r))
    no_acc_loop_ms = cuda_loop_ms(lambda: g.gated_crf_fused_cuda(y, f, r, need_acc=False))
    plain_ms = cuda_median_ms(lambda: g.gated_crf_potts_fused_plain(y, f, r), reps=10)

    ops, exps = gated_crf_work(b, c, nf, h, w, r)
    bound, by = bound_ms(ops, 4 * (2 * y.numel() + f.numel()))  # y + f read, acc written
    log(f"[gated_crf] fused pass {call_ms:.4f} ms per call, backward's scale {scale_ms:.4f} ms "
        f"per call (the earlier two-kernel design's forward + backward: 0.51 + 0.54 ms per call); "
        f"back to back {loop_ms:.4f} ms ({no_acc_loop_ms:.4f} ms without writing acc); "
        f"plain twin {plain_ms:.4f} ms; bound {bound:.4f} ms ({by}: {ops} fp32 operations; "
        f"{exps} exps on the special-function units apart)")
    log("[gated_crf] library_ms: none -- no single PyTorch call computes this function")
    return dict(name="gated_crf", route="cuda", source="fedicra_torch/csrc/gated_crf.cu",
                replaces="fedicra_tpu/ops/gated_crf_pallas.py:77 and :106",
                max_abs_err=max(errs), ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def gaussian_filter_inputs(dev):
    """The dense-CRF loss's inputs beside the headline config and the
    filter's inputs as dense_crf_loss forms them (scale_factor 0.5).

    Returns (images, logits, rois, feats (B, N, D), seg (B, N, C), rng)."""
    from fedicra_torch.losses.tree_energy import resize_linear, resize_nearest
    from fedicra_torch.ops.gaussian_filter_cuda import bilateral_features

    b, c, h, w = BATCH, 3, IMG, IMG
    rng = np.random.default_rng(3)
    images = torch.as_tensor(smooth_images(rng, b, h, w), device=dev)
    logits = torch.as_tensor(rng.normal(size=(b, h, w, c)).astype(np.float32), device=dev)
    rois = torch.as_tensor((rng.uniform(size=(b, h, w)) < 0.95).astype(np.float32), device=dev)
    hw = (h // 2, w // 2)
    feats = bilateral_features(resize_nearest(images * 255.0, hw), 15.0, 50.0).contiguous()
    seg = resize_linear(torch.softmax(logits, -1), hw) * resize_nearest(rois[..., None], hw)
    return images, logits, rois, feats, seg.reshape(b, hw[0] * hw[1], c).contiguous(), rng


def sample_rows(n: int, k: int = 256) -> torch.Tensor:
    """k query rows spread evenly over 0..n-1, both ends included."""
    return torch.linspace(0, n - 1, k).round().long().unique()


def direct_float64_rows(feats: torch.Tensor, values: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The filter's rows ``rows`` of every image in float64, from direct
    differences: sum_j exp(-1/2 ||f_i - f_j||^2) v_j over every column j."""
    f = feats.double()
    rows = rows.to(feats.device)
    out = []
    for k in range(f.shape[0]):  # one image at a time: (rows, N, D) differences
        d2 = ((f[k, rows][:, None, :] - f[k][None, :, :]) ** 2).sum(-1)
        out.append(torch.exp(-0.5 * d2) @ values[k].double())
    return torch.stack(out)


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
        pad = width - d - 1
        zeros = feats.new_zeros(b, n, pad)
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


def cuda_kernel_names(fn, *words: str):
    """Names of the CUDA kernels one call of fn launches that hold any of
    ``words``, from torch.profiler; "not traced" if it saw none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.events()
                    if e.device_type.name == "CUDA" and any(w in e.key.lower() for w in words)})
    return names or ["not traced"]


def phase_gaussian_filter(dev):
    """Kernel vs twin and vs float64 at the dense-CRF shape beside the
    headline config, times beside the library yardstick, then the loss path
    on the card; returns the JSON row (its launches are the loss path's)."""
    from fedicra_torch.losses.dense_crf import dense_crf_loss
    from fedicra_torch.ops import gaussian_filter_cuda as gf

    images, logits, rois, feats, seg, rng = gaussian_filter_inputs(dev)
    b, n, d = feats.shape
    c = seg.shape[2]
    cot = torch.as_tensor(rng.uniform(size=(b, n, c)).astype(np.float32), device=dev)

    out_k = gf.gaussian_filter_cuda(feats, seg)
    out_k2 = gf.gaussian_filter_cuda(feats, seg)
    seg_req = seg.clone().requires_grad_(True)
    (vjp_k,) = torch.autograd.grad(gf.gaussian_kernel_filter(feats, seg_req), seg_req, cot)
    out_p = gf.gaussian_filter_plain(feats, seg)
    vjp_p = gf.gaussian_filter_plain(feats, cot)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_k2):
        raise AssertionError("gaussian_filter: two runs on the same input differ")
    log(f"[gaussian] max |f|^2 {(feats * feats).sum(-1).max().item():.4g}")
    errs = {}
    rows = sample_rows(n)
    for name, got, want, vals in (("value", out_k, out_p, seg), ("vjp", vjp_k, vjp_p, cot)):
        err = (got - want).abs()
        errs[name] = err.max().item()
        log(f"[gaussian] {name}: max |kernel - plain| {errs[name]:.4g}, max relative "
            f"{(err / want.abs().clamp(min=1e-30)).max().item():.4g} (outputs {want.min().item():.4g}..{want.max().item():.4g})")
        # rtol 1e-3: the twin forms f_i.f_j - |f_i|^2/2 - |f_j|^2/2 with
        # |f|^2 up to ~900 here, so it carries ~1e-4 of each exponent's
        # rounding; the float64 direct sum below holds the kernel to 1e-4.
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)
        exact = direct_float64_rows(feats, vals, rows)
        sub = got[:, rows.to(dev)].double()
        log(f"[gaussian] {name}: {len(rows)} rows of each image against float64 direct sums: "
            f"max relative kernel {((sub - exact).abs() / exact.abs()).max().item():.4g}, "
            f"twin {((want[:, rows.to(dev)].double() - exact).abs() / exact.abs()).max().item():.4g}")
        torch.testing.assert_close(sub, exact, rtol=1e-4, atol=1e-6 * exact.abs().max().item())

    run_lib, width = attention_filter(feats, seg)
    out_lib = run_lib()
    lib_err = ((out_lib - out_p).abs() / out_p.abs().clamp(min=1e-30)).max().item()
    log(f"[gaussian] library: aten._scaled_dot_product_efficient_attention (memory-efficient "
        f"SDPA backend), head width {width}, kernels {cuda_kernel_names(run_lib, 'fmha', 'attention', 'mem_eff')}; "
        f"max relative error against the twin {lib_err:.4g}")
    del out_lib

    ms = cuda_median_ms(lambda: gf.gaussian_filter_cuda(feats, seg), reps=10, warmup=2)
    loop_ms = cuda_loop_ms(lambda: gf.gaussian_filter_cuda(feats, seg), n=10, reps=3, warmup=1)
    library_ms = cuda_median_ms(run_lib, reps=10, warmup=2)
    library_loop_ms = cuda_loop_ms(run_lib, n=10, reps=3, warmup=1)
    plain_ms = cuda_median_ms(lambda: gf.gaussian_filter_plain(feats, seg), reps=3, warmup=1)
    ops, exps = gaussian_filter_work(b, n, d, c)
    bound, by = bound_ms(ops, 4 * (feats.numel() + 2 * seg.numel()))
    log(f"[gaussian] plan: workspace of {gf._workspace_floats(b, n, d, c, dev.index or 0)} floats for the "
        f"column shares of the images split to fill the last wave")
    log(f"[gaussian] B={b} N={n} D={d} C={c}: kernel {ms:.4f} ms per call, {loop_ms:.4f} ms back to "
        f"back; library {library_ms:.4f} ms per call, {library_loop_ms:.4f} ms back to back; "
        f"plain {plain_ms:.4f} ms; bound {bound:.4f} ms ({by}: {ops} fp32 operations; {exps} exps "
        f"on the special-function units apart; {b * n * n} exps as the kernel takes them)")
    del out_k, out_k2, vjp_k, out_p, vjp_p, seg_req, run_lib
    torch.cuda.empty_cache()

    # the loss path: dense_crf_loss forward and backward at the full shape
    lg = logits.clone().requires_grad_(True)
    torch.cuda.synchronize()
    gf.reset_launches()
    loss = dense_crf_loss(images, torch.softmax(lg, -1), rois)
    loss.backward()
    torch.cuda.synchronize()
    launches = gf.launches["gaussian_filter"]
    log(f"[gaussian] dense_crf_loss {loss.item():.9g}, |dL/dlogits| max {lg.grad.abs().max().item():.4g}, "
        f"launches {launches}")
    if not (torch.isfinite(loss) and torch.isfinite(lg.grad).all() and lg.grad.abs().max() > 0):
        raise AssertionError("dense_crf_loss: non-finite or zero loss or gradient")
    if launches != 2:
        raise AssertionError(f"dense_crf_loss: expected 2 launches (forward, VJP), got {launches}")

    # the loss on the card against the CPU (twin) at a small input
    small = [x[:2, :32, :32] for x in (images, logits, rois)]
    results = []
    for device in (dev, "cpu"):
        im, lo, ro = (x.to(device) for x in small)
        lo = lo.clone().requires_grad_(True)
        val = dense_crf_loss(im, torch.softmax(lo, -1), ro)
        val.backward()
        results.append((val.item(), lo.grad.cpu()))
    (v_gpu, g_gpu), (v_cpu, g_cpu) = results
    log(f"[gaussian] small dense_crf_loss card {v_gpu:.9g} cpu {v_cpu:.9g}")
    if not math.isclose(v_gpu, v_cpu, rel_tol=1e-4):
        raise AssertionError(f"dense_crf_loss: card {v_gpu!r} vs cpu {v_cpu!r}")
    torch.testing.assert_close(g_gpu, g_cpu, rtol=1e-3, atol=1e-5 * g_cpu.abs().max().item())
    return dict(name="gaussian_filter", route="cuda", source="fedicra_torch/csrc/gaussian_filter.cu",
                replaces="fedicra_tpu/ops/pallas_kernels.py:38", launches=launches,
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=library_ms)


def serpentine_weights(h: int, w: int) -> np.ndarray:
    """MST weights [E] whose tree is one path from vertex 0 through every row
    in turn (left to right, then right to left): V levels of one vertex."""
    from fedicra_torch.ops.mst import grid_edges

    eu, ev = grid_edges(h, w)
    i, j = eu // w, eu % w
    horizontal = ev == eu + 1
    # the vertical edge at the end of each row: the right end below even rows, the left below odd
    turn = ~horizontal & (j == np.where(i % 2 == 0, w - 1, 0))
    return np.where(horizontal | turn, 1.0, 10.0).astype(np.float32)


def tree_guides(dev, rng, b: int, h: int, w: int, c: int, channels: int = 3):
    """The four guides of a tree-on step: a smooth image of ``channels``
    channels (the low guide) and aux logits of ``c`` classes upsampled 4x, 2x
    and 1x (the high guides), NHWC on ``dev``."""
    from fedicra_torch.losses.tree_energy import resize_linear

    low = torch.as_tensor(smooth_images(rng, b, h, w, channels), device=dev)
    highs = [
        resize_linear(torch.as_tensor(rng.normal(size=(b, h // s, w // s, c)).astype(np.float32),
                                      device=dev), (h, w))
        for s in (4, 2, 1)
    ]
    return low, highs


def phase_tree_plain(dev):
    """The plain route's tree chain (PyTorch ops: the twins of the tree
    kernels' route, off the main path on the card) at the main-path shape:
    MST, Euler tour and DFS-ordered filter, timed per call; one image's MST
    and tree on the card against the CPU, and the filter's forward and VJP."""
    from fedicra_torch.losses.tree_energy import mst_edge_weights
    from fedicra_torch.ops.mst import boruvka_mst, grid_edges
    from fedicra_torch.ops.tree import TreeStructure, build_tree
    from fedicra_torch.ops.tree_filter import tree_filter_refine

    b, h, w, c = BATCH, IMG, IMG, 3
    V = h * w
    rng = np.random.default_rng(4)
    low, highs = tree_guides(dev, rng, b, h, w, c)
    eu, ev = (torch.as_tensor(a, device=dev).long() for a in grid_edges(h, w))

    # the four trees of a step (low, then the three high guides) in one call
    dist = mst_edge_weights([low, *highs], eu, ev)
    sel = boruvka_mst(eu, ev, dist, V)
    struct = build_tree(eu, ev, sel, V)
    torch.cuda.synchronize()
    if not (sel.sum(dim=1) == V - 1).all():
        raise AssertionError("boruvka_mst: some image did not get V - 1 edges")
    mst_ms = cuda_median_ms(lambda: boruvka_mst(eu, ev, dist, V), reps=5, warmup=1)
    tree_ms = cuda_median_ms(lambda: build_tree(eu, ev, sel, V), reps=5, warmup=1)

    # card vs CPU on the same weights: a low-tree image and a 4x-upsampled
    # guide's (whose weights hold many near-ties)
    for k in (0, b):
        sel_cpu = boruvka_mst(eu.cpu(), ev.cpu(), dist[k].cpu(), V)
        if not torch.equal(sel_cpu, sel[k].cpu()):
            raise AssertionError(f"MST of image {k}: card and CPU select different edges")
        tree_cpu = build_tree(eu.cpu(), ev.cpu(), sel_cpu[None], V)
        for name, a_cpu, a_gpu in zip(TreeStructure._fields, tree_cpu, struct):
            if not torch.equal(a_cpu[0], a_gpu[k].cpu()):
                raise AssertionError(f"build_tree of image {k}: {name} differs between card and CPU")
    log(f"[tree-plain] MST and tree of images 0 and {b} equal on card and CPU")

    # the filter over the first high tree, its weights to the guide (4x upsampled)
    st = TreeStructure(*(a[b:2 * b] for a in struct))
    emb = highs[0].reshape(b, V, c).gather(1, st.dfs_vertices[..., None].expand(-1, -1, c))
    parent_emb = emb.gather(1, st.parent_pos[..., None].expand(-1, -1, c))
    logw = (-((emb - parent_emb) ** 2).sum(-1)).requires_grad_(True)
    x = torch.softmax(torch.as_tensor(rng.normal(size=(b, V, c)).astype(np.float32), device=dev), -1)
    x.requires_grad_(True)
    g = torch.as_tensor(rng.normal(size=(b, V, c)).astype(np.float32), device=dev)
    y = tree_filter_refine(x, logw, st.parent_pos, st.size)
    dx, dlogw = torch.autograd.grad(y, (x, logw), g, retain_graph=True)
    fwd_ms = cuda_median_ms(lambda: tree_filter_refine(x, logw, st.parent_pos, st.size), reps=5, warmup=1)
    bwd_ms = cuda_median_ms(lambda: torch.autograd.grad(y, (x, logw), g, retain_graph=True),
                            reps=5, warmup=1)

    # image 0's filter and VJP on the CPU
    cpu = [t[:1].detach().cpu() for t in (x, logw, st.parent_pos, st.size, g)]
    xc, lc = cpu[0].requires_grad_(True), cpu[1].requires_grad_(True)
    yc = tree_filter_refine(xc, lc, cpu[2], cpu[3])
    dxc, dlc = torch.autograd.grad(yc, (xc, lc), cpu[4])
    torch.testing.assert_close(y[:1].detach().cpu(), yc.detach(), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dx[:1].cpu(), dxc, rtol=1e-3, atol=1e-4 * dxc.abs().max().item())
    torch.testing.assert_close(dlogw[:1].cpu(), dlc, rtol=1e-3, atol=1e-4 * dlc.abs().max().item())
    log(f"[tree-plain] filter of image 0 on card vs CPU: y max |diff| "
        f"{(y[:1].detach().cpu() - yc.detach()).abs().max().item():.3g}")
    log(f"[tree-plain] plain route per call at B={b}, {h}x{w}: MST of {4 * b} images "
        f"{mst_ms:.3f} ms, build_tree of {4 * b} {tree_ms:.3f} ms, filter forward {fwd_ms:.3f} ms, "
        f"filter backward {bwd_ms:.3f} ms (high tree: dx and dlogw); the main path takes the "
        f"kernels ([tree-kernels])")
    del struct, sel, dist, y, dx, dlogw
    torch.cuda.empty_cache()


def tree_chain_work(b: int, h: int, w: int, c: int, d: int, levels: int):
    """(fp32 operations, bytes) that each tree kernel's function needs at
    least, by kernel name, for one step's four trees of ``b`` images each
    (guides of ``d`` channels for the rooting; filters of ``c`` classes,
    whose high guides have ``c`` channels). ``levels`` is this run's sum of
    (BFS levels + 1) over the 4b images: the level offsets' words.

    Bytes: each input of the function read once and each output written once
    (int32 indices, fp32 values, a byte a mask entry); what the design moves
    beyond that is ``tree_chain_saved_bytes``. ``tree_mst`` reads the
    weights [N, E] and writes the mask. ``tree_root`` reads the mask and the
    guides and writes order, parent, ppos and w (V each) and the level
    offsets. A filter's tree is order, ppos and w (the child ranges and
    level offsets follow from ppos). ``tree_fwd`` reads x and the tree and
    writes y. ``tree_bwd`` is the filter's VJP: it reads g, x and the tree
    and writes dx; on a high tree it also reads the guide and writes d
    embed. The filter rows are the mean of the step's four launches (the
    low tree and three high trees), as the path runs them. Operations (an
    FMA counts two): the weights' squared distances and scaling; the upward
    pass's FMA a channel an edge, the downward pass's product and FMA a
    channel and 1 - w^2 a vertex, the forward's divisions; the backward's
    inputs, the same passes on 2C channels, and on a high tree the
    crossing-pair sums (6 FMAs a channel a class, 4 more an edge) and d
    embed's two terms an edge. The MST's comparisons are not fp32 work.
    The dependency chain that binds the design is apart: one block step per
    BFS level in tree_root, and in each filter pass a step per level.
    """
    V, E, n = h * w, (h - 1) * w + h * (w - 1), 4 * b
    two_pass = lambda k: (V - 1) * 2 * k + (V - 1) * (2 + 3 * k)
    bwd_low = (b * (V * 3 * c + two_pass(2 * c)), b * 4 * (2 * V * c + 3 * V + V * c))
    edge = (b * ((V - 1) * (12 * c + 4) + (V - 1) * 2 * 3 * c), b * 4 * 2 * V * c)
    return {
        "tree_mst": (0, n * E * 5),
        "tree_root": (n * (V - 1) * (3 * d + 2), n * E + n * V * d * 4 + 4 * (4 * n * V + levels)),
        "tree_fwd": (b * (two_pass(c + 1) + V * c), b * 4 * (V * c + 3 * V + V * c)),
        "tree_bwd": tuple(lo + 3 * e / 4 for lo, e in zip(bwd_low, edge)),  # 1 low, 3 high
    }


def tree_pass_times(name: str, kernel, args, n_levels, b: int, prefix: str = "[tree-kernels]") -> None:
    """Each tree's upward and downward pass, from the passes kernel's
    %globaltimer stamps (start, between the passes, end of each image's
    block): the slowest image's ms and the mean over images of ns per level."""
    from fedicra_torch.ops import tree_filter_cuda as tfc

    names = ("low", "high 4x", "high 2x", "high 1x")
    parts = []
    for k, a in enumerate(args):
        kernel(*a)  # warm
        stamps = torch.zeros((b, 3), dtype=torch.int64, device=a[0].device)
        kernel(*a, stamps=stamps)
        torch.cuda.synchronize()
        st = stamps.cpu().double()
        levels = n_levels[k * b:(k + 1) * b].double()
        up, down = st[:, 1] - st[:, 0], st[:, 2] - st[:, 1]
        parts.append(f"{names[k]} up {up.max().item() / 1e6:.4f} ms ({(up / levels).mean().item():.1f} "
                     f"ns a level), down {down.max().item() / 1e6:.4f} ms "
                     f"({(down / levels).mean().item():.1f} ns a level)")
    log(f"{prefix} {name} passes by tree (%globaltimer, {tfc.consumer_warps()} consumer warps): "
        + "; ".join(parts))


MST_COUNTS = ("phase-1 rounds", "components left", "edges left", "phase-2 rounds",
              "of them on device memory")
TREE_NAMES = ("low", "high 4x", "high 2x", "high 1x")
# mst_tile_kernel<32>'s register file a thread: the launch bound (two 1,024-thread
# blocks an SM) caps it at 32 registers, and ptxas spills 32 bytes to local
# memory; that build ran faster than a 44-register one without the cap (PERF.md
# section 6). A build that needs more fails the phase.
MST_TILE_REGISTERS, MST_TILE_LOCAL_BYTES = 32, 32


def hold_tree_to_twin(name: str, tree, twin, V: int) -> float:
    """K2's arrays exactly the BFS twin's (the level offsets up to each
    image's count), w at rtol 1e-6; returns w's max |diff|."""
    torch.cuda.synchronize()
    for field in ("order", "parent", "ppos", "cptr", "n_levels"):
        if not torch.equal(getattr(tree, field), getattr(twin, field)):
            raise AssertionError(f"{name}: {field} differs from the BFS twin's")
    used = torch.arange(V + 1, device=tree.level.device) <= tree.n_levels[:, None].long()
    if not torch.equal(tree.level[used], twin.level[used]):
        raise AssertionError(f"{name}: level offsets differ from the BFS twin's")
    # atol: the smallest normal fp32 (denormal weights)
    torch.testing.assert_close(tree.w, twin.w, rtol=1e-6, atol=1.2e-38)
    return (tree.w - twin.w).abs().max().item()


def mst_phases(dist, h: int, w: int, b: int, prefix: str = "[tree-kernels]") -> None:
    """K1's counts by tree (max and mean over its images) and its phases'
    times (the kernel's %globaltimer stamps: phase 1 from its first tile's
    start to its last tile's end over all images, then phase 2's blocks;
    the slowest phase 2 of the images whose first rounds ran on device
    memory). Its phase-1 kernel must keep to its registers and local
    memory (``MST_TILE_REGISTERS``, ``MST_TILE_LOCAL_BYTES``)."""
    from fedicra_torch.ops import tree_filter_cuda as tfc

    n = dist.shape[0]
    counts = torch.zeros((n, 5), dtype=torch.int32, device=dist.device)
    stamps = torch.zeros((n, 4), dtype=torch.int64, device=dist.device)
    tfc.tree_mst_cuda(dist, h, w)  # warm
    tfc.tree_mst_cuda(dist, h, w, counts=counts, stamps=stamps)
    torch.cuda.synchronize()
    c, st = counts.cpu().double(), stamps.cpu().double()
    for k in range(n // b):
        ck = c[k * b:(k + 1) * b]
        log(f"{prefix} tree_mst counts, tree {k} ({TREE_NAMES[k]}), max / mean over {b} images: "
            + ", ".join(f"{name} {ck[:, i].max().item():.0f} / {ck[:, i].mean().item():.1f}"
                        for i, name in enumerate(MST_COUNTS)))
    p1 = (st[:, 1].max() - st[:, 0].min()).item() / 1e6
    p2 = (st[:, 3].max() - st[:, 2].min()).item() / 1e6
    between = (st[:, 2].min() - st[:, 1].max()).item() / 1e6
    p2_img = (st[:, 3] - st[:, 2]) / 1e6
    on_dev = c[:, 4] > 0
    log(f"{prefix} tree_mst phases (%globaltimer, tile {tfc.MST_TILE}): phase 1 "
        f"{p1:.4f} ms, to phase 2's start {between:.4f} ms (phase 1b), phase 2 {p2:.4f} ms "
        f"(slowest image {p2_img.max().item():.4f} ms; of the {int(on_dev.sum())} images "
        f"starting on device memory {p2_img[on_dev].max().item() if on_dev.any() else 0.0:.4f} ms, "
        f"of the others {p2_img[~on_dev].max().item() if (~on_dev).any() else 0.0:.4f} ms)")
    regs, local = tfc.mst_tile_registers()
    if regs > MST_TILE_REGISTERS or local > MST_TILE_LOCAL_BYTES:
        raise AssertionError(f"mst_tile_kernel<{tfc.MST_TILE}> takes {regs} registers and {local} "
                             f"local bytes a thread (budget {MST_TILE_REGISTERS}, {MST_TILE_LOCAL_BYTES})")
    log(f"{prefix} mst_tile_kernel<{tfc.MST_TILE}>: {regs} registers and {local} bytes of local "
        f"memory (spills) a thread (budget {MST_TILE_REGISTERS}, {MST_TILE_LOCAL_BYTES})")


def bfs_levels_by_tree(sel, embed, h: int, w: int, b: int, sigma: float, n_levels,
                       prefix: str = "[tree-kernels]") -> None:
    """K2's BFS time and ns a level by tree, from its %globaltimer stamps."""
    from fedicra_torch.ops import tree_filter_cuda as tfc

    n = sel.shape[0]
    stamps = torch.zeros((n, 2), dtype=torch.int64, device=sel.device)
    tfc.tree_root_cuda(sel, embed, h, w, b, sigma, stamps=stamps)
    torch.cuda.synchronize()
    st = stamps.cpu().double()
    bfs = st[:, 1] - st[:, 0]
    per = bfs / n_levels.double()
    log(f"{prefix} tree_root BFS by tree (%globaltimer): "
        + "; ".join(f"{TREE_NAMES[k]} {bfs[k * b:(k + 1) * b].max().item() / 1e6:.4f} ms "
                    f"({per[k * b:(k + 1) * b].mean().item():.1f} ns a level)" for k in range(n // b)))


def serpentine_order(h: int, w: int) -> np.ndarray:
    """The queue of ``serpentine_weights``'s tree from vertex 0: row by row,
    even rows left to right, odd rows right to left."""
    order = np.arange(h * w).reshape(h, w)
    order[1::2] = order[1::2, ::-1]
    return order.reshape(-1)


def path_tree_checked(h: int, w: int, embed, sigma: float):
    """K1 and K2 on a path-shaped tree (``serpentine_weights``, one image):
    the MST bit for bit ``boruvka_mst``'s; the BFS arrays exactly the path's
    (order the serpentine, each position's parent the one before, child
    ranges one wide, V levels of one vertex: what the twin gives, which would
    walk all V levels), and the twin's on a 64 x 64 path. Returns the tree."""
    from fedicra_torch.ops import tree_filter_cuda as tfc
    from fedicra_torch.ops.mst import boruvka_mst, grid_edges

    dev = embed.device
    V = h * w
    sw = torch.as_tensor(serpentine_weights(h, w), device=dev)[None].contiguous()
    eu, ev = (torch.as_tensor(a, device=dev).long() for a in grid_edges(h, w))
    sel = tfc.tree_mst_cuda(sw, h, w)
    if not torch.equal(sel, boruvka_mst(eu, ev, sw, V)):
        raise AssertionError("tree_mst on the path-shaped tree: edges differ from boruvka_mst's")
    path = tfc.tree_root_cuda(sel, embed, h, w, 0, sigma)
    order = torch.as_tensor(serpentine_order(h, w), dtype=torch.int32, device=dev)
    q = torch.arange(V, dtype=torch.int32, device=dev)
    parent = torch.empty_like(order)
    parent[order.long()] = torch.cat([order[:1], order[:-1]])
    want = {"order": order, "parent": parent, "ppos": (q - 1).clamp(min=0),
            "cptr": torch.cat([q + 1, q[-1:] + 1]).clamp(max=V), "level": torch.cat([q, q[-1:] + 1]),
            "n_levels": torch.tensor([V], dtype=torch.int32, device=dev)}
    for field, a in want.items():
        if not torch.equal(getattr(path, field)[0], a.reshape(getattr(path, field)[0].shape)):
            raise AssertionError(f"tree_root on the path-shaped tree: {field} is not the path's")
    stamps = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    tfc.tree_root_cuda(sel, embed, h, w, 0, sigma, stamps=stamps)
    torch.cuda.synchronize()
    bfs_ns = (stamps[0, 1] - stamps[0, 0]).item()
    hs = 64
    ss = torch.as_tensor(serpentine_weights(hs, hs), device=dev)[None].contiguous()
    e_s, v_s = (torch.as_tensor(a, device=dev).long() for a in grid_edges(hs, hs))
    sel_s = tfc.tree_mst_cuda(ss, hs, hs)
    if not torch.equal(sel_s, boruvka_mst(e_s, v_s, ss, hs * hs)):
        raise AssertionError("tree_mst on the 64 x 64 path: edges differ from boruvka_mst's")
    emb_s = embed[:, :hs * hs].contiguous()
    hold_tree_to_twin("tree_root on the 64 x 64 path", tfc.tree_root_cuda(sel_s, emb_s, hs, hs, 0, sigma),
                      tfc.tree_root_plain(sel_s, emb_s, hs, hs, 0, sigma), hs * hs)
    log(f"[tree-kernels] a path-shaped tree ({V} levels of one vertex): tree_mst bit for bit "
        f"boruvka_mst's, tree_root the path's arrays exactly (and the twin's on a 64 x 64 path); "
        f"its BFS {bfs_ns / 1e6:.4f} ms, {bfs_ns / V:.1f} ns a level")
    return path


def mst_checked(prefix: str, dist, eu, ev, h: int, w: int, b: int, times: dict, errs: dict):
    """K1 on a step's four trees (``dist``: the weights of their images, ``b``
    a tree): bit for bit ``boruvka_mst``'s on every image, timed per call and
    back to back beside the twin, with its counts and phases
    (``mst_phases``). Returns the masks."""
    from fedicra_torch.ops import tree_filter_cuda as tfc
    from fedicra_torch.ops.mst import boruvka_mst

    V = h * w
    sel = tfc.tree_mst_cuda(dist, h, w)
    differ = (sel != boruvka_mst(eu, ev, dist, V)).sum(dim=1)
    if differ.any() or not (sel.sum(dim=1) == V - 1).all():
        raise AssertionError(f"{prefix} tree_mst: edges that differ from boruvka_mst per image "
                             f"{differ.tolist()}")
    errs["tree_mst"] = float(differ.sum())
    log(f"{prefix} tree_mst: all {dist.shape[0]} images select boruvka_mst's edges bit for bit")
    times["tree_mst"] = (cuda_median_ms(lambda: tfc.tree_mst_cuda(dist, h, w), reps=10, warmup=2),
                         cuda_loop_ms(lambda: tfc.tree_mst_cuda(dist, h, w), n=10, reps=3),
                         cuda_median_ms(lambda: boruvka_mst(eu, ev, dist, V), reps=3, warmup=1))
    mst_phases(dist, h, w, b, prefix)
    return sel


def root_timed(sel, embed, h: int, w: int, b: int, sigma: float, times: dict) -> None:
    """K2's time per call and back to back, and its BFS twin's (one call: it
    takes seconds, and ran once already)."""
    from fedicra_torch.ops import tree_filter_cuda as tfc

    times["tree_root"] = (
        cuda_median_ms(lambda: tfc.tree_root_cuda(sel, embed, h, w, b, sigma), reps=10, warmup=2),
        cuda_loop_ms(lambda: tfc.tree_root_cuda(sel, embed, h, w, b, sigma), n=10, reps=3),
        cuda_median_ms(lambda: tfc.tree_root_plain(sel, embed, h, w, b, sigma), reps=1, warmup=0))


def filters_checked(prefix: str, trees, embs, x, g, errs: dict):
    """K3 and K4 on a step's four trees against their twins, chained as the
    path chains them: the low tree filters the probabilities ``x`` and each
    high tree the y before it; the backward runs from the last tree to the
    low one, each dx the g of the tree before. y at rtol 1e-4, dx and d
    embed at rtol 1e-3 / atol 1e-4 max. Each kernel and its twin take the
    same inputs; the twin's one call a tree (seconds each) is its time.
    Returns (K3's arguments by tree, K4's, {name: the twin's mean ms})."""
    from fedicra_torch.ops import tree_filter_cuda as tfc

    def once_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    fwd_args, saved, plain_ms = [], [], {"tree_fwd": 0.0, "tree_bwd": 0.0}
    cur = x
    for k, t in enumerate(trees):
        fwd_args.append((cur, t))
        A, F, y = tfc.tree_filter_fwd_cuda(cur, t)
        (_, _, y_p), ms = once_ms(lambda: tfc.tree_filter_fwd_plain(cur, t))
        plain_ms["tree_fwd"] += ms / 4
        torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-5)
        errs["tree_fwd"] = max(errs.get("tree_fwd", 0.0), (y - y_p).abs().max().item())
        saved.append((y, A, F))
        cur = y
    bwd_args, cur = [None] * 4, g
    for k in reversed(range(4)):
        bwd_args[k] = (cur, *saved[k], trees[k], embs[k])
        dx, de = tfc.tree_filter_bwd_cuda(*bwd_args[k])
        (dx_p, de_p), ms = once_ms(lambda: tfc.tree_filter_bwd_plain(*bwd_args[k]))
        plain_ms["tree_bwd"] += ms / 4
        for got, want in ((dx, dx_p), (de, de_p))[:1 if de is None else 2]:
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4 * want.abs().max().item())
            errs["tree_bwd"] = max(errs.get("tree_bwd", 0.0), (got - want).abs().max().item())
        cur = dx
    log(f"{prefix} tree_fwd y and tree_bwd dx, d embed agree with the twins on all four "
        f"trees, chained: max |diff| {errs['tree_fwd']:.3g}, {errs['tree_bwd']:.3g}")
    return fwd_args, bwd_args, plain_ms


def filters_timed(prefix: str, fwd_args, bwd_args, plain_ms: dict, depths, n_levels, b: int,
                  times: dict) -> None:
    """K3's and K4's time per call by tree, and per call and back to back as
    the mean of the step's four launches (into ``times`` beside the twin's);
    each pass's time and ns a level by tree."""
    from fedicra_torch.ops import tree_filter_cuda as tfc

    for name, kernel, args in (("tree_fwd", tfc.tree_filter_fwd_cuda, fwd_args),
                               ("tree_bwd", tfc.tree_filter_bwd_cuda, bwd_args)):
        chain_of_four = lambda: [kernel(*a) for a in args]
        per_tree = [cuda_median_ms(lambda: kernel(*a), reps=5, warmup=1) for a in args]
        log(f"{prefix} {name} per call by tree (depth): "
            + ", ".join(f"{t:.4f} ms ({d})" for t, d in zip(per_tree, depths)))
        times[name] = (cuda_median_ms(chain_of_four, reps=10, warmup=2) / 4,
                       cuda_loop_ms(chain_of_four, n=10, reps=3) / 4, plain_ms[name])
        tree_pass_times(name, kernel, args, n_levels, b, prefix)


TREE_REPLACES = {
    "tree_mst": "fedicra_tpu/native/tree_filter_host.cpp:78",
    "tree_root": "fedicra_tpu/native/tree_filter_host.cpp:131",
    "tree_fwd": "fedicra_tpu/native/tree_filter_host.cpp:166",
    "tree_bwd": "fedicra_tpu/native/tree_filter_host.cpp:230",
}


def tree_rows(prefix: str, times: dict, errs: dict, work: dict, chain: int, suffix: str = "") -> list:
    """Each tree kernel's line (ms per call and back to back, twin, bound)
    and its JSON row, named ``name + suffix``; launches are filled in from a
    path's run."""
    rows = []
    for name, (ms, loop_ms, plain_ms) in times.items():
        bound, by = bound_ms(*work[name])
        per = " (mean of the step's four launches)" if name in ("tree_fwd", "tree_bwd") else ""
        log(f"{prefix} {name}: per call{per} {ms:.4f} ms, back to back {loop_ms:.4f} ms; twin "
            f"{plain_ms:.3f} ms; bound {bound:.4f} ms ({by}; {work[name][1] / 1e6:.1f} MB); "
            f"dependency chain {'-' if name == 'tree_mst' else chain} levels")
        rows.append(dict(name=name + suffix, route="cuda", source="fedicra_torch/csrc/tree_filter.cu",
                         replaces=TREE_REPLACES[name], launches=None, max_abs_err=errs[name], ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None))
    return rows


TREE_SIGMA = 0.02  # the tree term's sigma (``multi_scale_tree_energy_loss``'s default)


def tree_kernels_step(dev, prefix: str, rng, b: int, h: int, w: int, c: int, channels: int = 3):
    """The tree chain's four kernels against their twins on one step's four
    trees as a tree-on step builds them: ``b`` images of h x w, the low
    guide a smooth image of ``channels`` channels and the highs aux logits of
    ``c`` classes upsampled 4x, 2x and 1x (``tree_guides``). A gray image
    (FAZ's) is put on 256 levels, whose many equal edge weights the MST's
    (weight, edge index) order must break as ``boruvka_mst`` does, and
    repeated to 3 channels, as the objective repeats it.

    K1 bit for bit ``boruvka_mst``'s, with its counts and phases (how many
    images start phase 2 on device memory); K1 and K2 through
    ``native_structures`` (one launch each), the trees exactly the BFS
    twin's on the same guides (zero-padded to the widest) and w at rtol
    1e-6; each tree's BFS depth and widest level; K3 and K4 against their
    twins, chained (``filters_checked``); each kernel's time per call and
    back to back beside its twin's. Returns a namespace of what the step
    built, its times, errors and ``tree_chain_work``, for ``tree_rows``."""
    import types

    import torch.nn.functional as F

    from fedicra_torch.losses.tree_energy import mst_edge_weights, native_structures
    from fedicra_torch.ops import tree_filter_cuda as tfc
    from fedicra_torch.ops.mst import grid_edges

    V, sigma = h * w, TREE_SIGMA
    low, highs = tree_guides(dev, rng, b, h, w, c, channels=channels)
    if channels == 1:
        low = (torch.round(low * 255.0) / 255.0).repeat(1, 1, 1, 3)
    guides = [low, *highs]
    eu, ev = (torch.as_tensor(a, device=dev).long() for a in grid_edges(h, w))
    dist = mst_edge_weights(guides, eu, ev)
    log(f"{prefix} low guide: {channels} image channel(s) as {low.shape[-1]}, "
        f"{torch.unique(dist[:b]).numel()} distinct MST weights over its {b} x {dist.shape[1]} edges")
    times, errs = {}, {}
    sel = mst_checked(prefix, dist, eu, ev, h, w, b, times, errs)

    before = dict(tfc.launches)
    per_guide = native_structures(guides, sigma)
    if (tfc.launches["tree_mst"], tfc.launches["tree_root"]) != (before["tree_mst"] + 1,
                                                                  before["tree_root"] + 1):
        raise AssertionError(f"{prefix} native_structures did not take one K1 and one K2 launch")
    d_max = max(gd.shape[-1] for gd in guides)
    embed = torch.cat([F.pad(gd.reshape(b, V, -1), (0, d_max - gd.shape[-1])) for gd in guides]).contiguous()
    tree = tfc.BFSTree(*(torch.cat(parts) for parts in zip(*per_guide)))
    errs["tree_root"] = hold_tree_to_twin(f"{prefix} tree_root", tree,
                                          tfc.tree_root_plain(sel, embed, h, w, b, sigma), V)
    n_levels = tree.n_levels.long().cpu()
    widths = torch.diff(tree.level.long(), dim=1).cpu()
    depths = []
    for k, name in enumerate(TREE_NAMES):
        imgs = range(k * b, (k + 1) * b)
        depths.append(max(int(n_levels[i]) - 1 for i in imgs))
        widest = max(int(widths[i, :n_levels[i]].max()) for i in imgs)
        log(f"{prefix} tree {k} ({name}): max BFS depth {depths[k]}, widest level {widest} "
            f"vertices over its {b} images")
    log(f"{prefix} tree_root (D = {d_max}): order, parent, ppos, cptr, levels equal the BFS twin's; "
        f"w max |diff| {errs['tree_root']:.3g}")
    root_timed(sel, embed, h, w, b, sigma, times)
    bfs_levels_by_tree(sel, embed, h, w, b, sigma, n_levels, prefix)

    trees = [tree.images(k * b, (k + 1) * b) for k in range(4)]
    embs = [None] + [gd.reshape(b, V, c).contiguous() for gd in highs]
    x = torch.softmax(torch.as_tensor(rng.normal(size=(b, V, c)).astype(np.float32), device=dev), -1)
    g = torch.as_tensor(rng.normal(size=(b, V, c)).astype(np.float32), device=dev)
    fwd_args, bwd_args, plain_ms = filters_checked(prefix, trees, embs, x, g, errs)
    filters_timed(prefix, fwd_args, bwd_args, plain_ms, depths, n_levels, b, times)
    work = tree_chain_work(b, h, w, c, d_max, int((n_levels + 1).sum()))
    return types.SimpleNamespace(guides=guides, eu=eu, ev=ev, sel=sel, embed=embed, trees=trees,
                                 x=x, g=g, times=times, errs=errs, work=work,
                                 chain=int(n_levels.max()))


def tree_chain_saved_bytes(b: int, h: int, w: int, c: int) -> int:
    """Bytes a filter launch moves beyond its function's: the forward's A and
    F ([x, 1] channels each), written by ``tree_fwd`` and read again by
    ``tree_bwd``, where the native code recomputes them from x."""
    return b * h * w * 2 * (c + 1) * 4


def phase_tree_kernels(dev):
    """The tree chain's four kernels against their plain twins at the main
    path's shape (ODOC: B=12, 384^2, C=3) by ``tree_kernels_step``; then the
    per-level floor on a path-shaped tree, and the filter's forward and
    backward against the plain route's (DFS order) on the step's trees.
    Returns the four JSON rows (their launches are filled in from the main
    path's run)."""
    from fedicra_torch.ops import tree_filter_cuda as tfc
    from fedicra_torch.ops.tree import build_tree
    from fedicra_torch.ops.tree_filter import tree_filter

    b, h, w, c = BATCH, IMG, IMG, 3
    V, sigma = h * w, TREE_SIGMA
    tfc.reset_launches()
    step = tree_kernels_step(dev, "[tree-kernels]", np.random.default_rng(4), b, h, w, c)
    x, g, trees, eu, ev, sel = step.x, step.g, step.trees, step.eu, step.ev, step.sel
    # the per-level floor: a path-shaped tree of one image (V levels of one vertex)
    path = path_tree_checked(h, w, step.embed[:1].contiguous(), sigma)
    xp, gp = x[:1].contiguous(), g[:1].contiguous()
    Ap, Fp, yp = tfc.tree_filter_fwd_cuda(xp, path)
    floor = []
    for name, call in (("tree_fwd", lambda st: tfc.tree_filter_fwd_cuda(xp, path, stamps=st)),
                       ("tree_bwd", lambda st: tfc.tree_filter_bwd_cuda(gp, yp, Ap, Fp, path, None,
                                                                        stamps=st))):
        stamps = torch.zeros((1, 3), dtype=torch.int64, device=dev)
        call(stamps)
        torch.cuda.synchronize()
        st = stamps[0].cpu().double()
        floor.append(f"{name} up {(st[1] - st[0]).item() / V:.1f}, down {(st[2] - st[1]).item() / V:.1f}")
    log(f"[tree-kernels] a path-shaped tree ({V} levels of one vertex, one image), ns a level: "
        + "; ".join(floor))
    del path, Ap, Fp, yp
    log(f"[tree-kernels] the design's extra traffic: tree_fwd writes A and F and tree_bwd reads "
        f"them, {tree_chain_saved_bytes(b, h, w, c) / 1e6:.1f} MB a launch each, beyond the bounds' "
        f"bytes (the native code recomputes them from x)")

    # the filter by the kernels (autograd) against the plain route's (DFS
    # order) on the same trees: the plain route in float64 referees on all
    # four, in fp32 as well on the low and the first high tree. The fp32
    # plain route drifts from exact with a tree's depth, through its log
    # path products (~1e-4 on y of the 1x noise tree), so there it is printed.
    plain = functools.partial(tree_filter, sigma=sigma)
    names = ("low (smooth image)", "high, 4x upsampled", "high, 2x upsampled", "high, 1x (noise)")
    for k, name in enumerate(names):
        low_tree = k == 0
        e = step.guides[k].reshape(b, V, -1).contiguous()
        struct = build_tree(eu, ev, sel[k * b:(k + 1) * b], V)
        outs = {}
        for route, filt, st, dt in (("kernels", tfc.tree_filter, trees[k], torch.float32),
                                    ("plain fp32", plain, struct, torch.float32),
                                    ("plain fp64", plain, struct, torch.float64)):
            xr, er = x.to(dt).requires_grad_(True), e.to(dt).requires_grad_(not low_tree)
            yr = filt(xr, er, st, low_tree=low_tree)
            grads = torch.autograd.grad(yr, [xr] if low_tree else [xr, er], g.to(dt))
            outs[route] = [yr.detach(), *grads]
        gaps = {}
        for route, ref in (("kernels", "plain fp64"), ("kernels", "plain fp32"), ("plain fp32", "plain fp64")):
            want = outs[ref]
            got = [t.to(want[0].dtype) for t in outs[route]]
            gaps[f"{route} vs {ref}"] = [f"{(a - w_).abs().max().item():.3g}" for a, w_ in zip(got, want)]
            if route == "kernels" and (ref == "plain fp64" or k < 2):
                torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
                for a, w_ in zip(got[1:], want[1:]):
                    torch.testing.assert_close(a, w_, rtol=1e-3, atol=1e-4 * w_.abs().max().item())
        log(f"[tree-kernels] tree {k} ({name}) on the same MST, max |diff| of y and the "
            f"gradients: {gaps}")
    rows = tree_rows("[tree-kernels]", step.times, step.errs, step.work, step.chain)
    tfc.reset_launches()
    del outs, struct, step, trees, sel
    torch.cuda.empty_cache()
    return rows


# the DSN heads' inputs, (channels, side) at batch 12: ODOC's three at 384^2, FAZ's at 256^2
DSN_HEAD_SHAPES = {"odoc": ((64, 96), (32, 192), (16, 384)), "faz": ((64, 64), (32, 128), (16, 256))}
DSN_HIDDEN = 512


def dsn_head_inputs(dev, c: int, side: int, batch: int = BATCH, seed: int = 7):
    """A DSN head's input (a decoder stage's output: LeakyReLU of a smooth
    field, so that neighbouring taps correlate), and its 3x3 conv's weight
    and bias drawn as torch's default initialisation draws them."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(batch, c, side, side, generator=g, device=dev)
    x = F.leaky_relu(3 * F.avg_pool2d(noise, 3, 1, 1), 0.01).contiguous()
    bound = 1.0 / (9 * c) ** 0.5
    w = (torch.rand(DSN_HIDDEN, c, 3, 3, generator=g, device=dev) * 2 - 1) * bound
    b = (torch.rand(DSN_HIDDEN, generator=g, device=dev) * 2 - 1) * bound
    return x, w, b


def direct_float64_moments(x, w, b=None, chunk: int = 64):
    """The conv's output in float64, ``chunk`` output channels at a time: its
    batch mean and biased variance."""
    import torch.nn.functional as F

    means, variances = [], []
    for o in range(0, w.shape[0], chunk):
        bias = None if b is None else b[o:o + chunk].double()
        y = F.conv2d(x.double(), w[o:o + chunk].double(), bias, padding=1)
        means.append(y.mean(dim=(0, 2, 3)))
        variances.append(y.var(dim=(0, 2, 3), unbiased=False))
        del y
    return torch.cat(means), torch.cat(variances)


def dsn_stats_work(b: int, c: int, h: int, w: int, hidden: int = DSN_HIDDEN):
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


def host_call_us(fn, calls: int = 100) -> float:
    """Host microseconds a call of ``fn`` takes to return (what it issues
    left to the card), the median of five runs of ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def phase_dsn_stats(dev) -> list:
    """[dsn-stats]: the heads' moment kernels at the six head shapes (ODOC's
    and FAZ's three): mean and variance against float64 direct statistics
    and the plain twin at rtol 1e-5, the running buffers against the twin's;
    each head timed per call and back to back beside its bound, the twin and
    the library composition (cuDNN's conv, then ``torch.batch_norm_stats``).
    Returns a JSON row a task, its times the sums over a contrast forward's
    three heads (its launches the main path's)."""
    from fedicra_torch.ops import dsn_stats_cuda as dsn

    rows = []
    for task, shapes in DSN_HEAD_SHAPES.items():
        tot = dict(ms=0.0, loop=0.0, plain=0.0, library=0.0, bound=0.0, err=0.0)
        for head, (c, side) in enumerate(shapes, 1):
            x, w, b = dsn_head_inputs(dev, c, side)
            running = (torch.rand(DSN_HIDDEN, device=dev), torch.rand(DSN_HIDDEN, device=dev) + 0.5)
            running_plain = tuple(t.clone() for t in running)
            dsn.reset_launches()
            mean, var = dsn.conv3x3_batch_moments(x, w, b, running=running)
            torch.cuda.synchronize()
            if dsn.launches != {"dsn_stats": 1}:
                raise AssertionError(f"dsn_stats {task} head{head}: launches {dsn.launches}")
            want_mean, want_var = direct_float64_moments(x, w, b)
            plain_mean, plain_var = dsn.conv3x3_batch_moments_plain(x, w, b, running=running_plain)
            err = max(((mean - want_mean).abs() / want_mean.abs()).max().item(),
                      ((var - want_var).abs() / want_var).max().item())
            log(f"[dsn-stats] {task} head{head} ({BATCH} x {c} x {side}^2): max relative gap to "
                f"float64 {err:.3g} (mean, variance), to the twin "
                f"{((var - plain_var).abs() / plain_var).max().item():.3g} (variance)")
            for got, want in ((mean, want_mean), (var, want_var), (mean, plain_mean), (var, plain_var)):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
            for got, want in zip(running, running_plain):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
            del want_mean, want_var, plain_mean, plain_var
            call_ms = cuda_median_ms(lambda: dsn.conv3x3_batch_moments(x, w, b))
            loop_ms = cuda_loop_ms(lambda: dsn.conv3x3_batch_moments(x, w, b))
            host_us = host_call_us(lambda: dsn.conv3x3_batch_moments(x, w, b, running=running))
            plain_ms = cuda_median_ms(lambda: dsn.conv3x3_batch_moments_plain(x, w, b), reps=5)
            library_ms = cuda_median_ms(lambda: torch.batch_norm_stats(
                torch.nn.functional.conv2d(x, w, b, padding=1), 1e-5))
            ops, nbytes = dsn_stats_work(BATCH, c, side, side)
            bound, by = bound_ms(ops, nbytes)
            log(f"[dsn-stats] {task} head{head}: {call_ms:.4f} ms per call, {loop_ms:.4f} ms back "
                f"to back; bound {bound:.4f} ms ({by}: {ops} fp32 operations, {nbytes} bytes; "
                f"{100 * bound / loop_ms:.1f}% of it back to back); plain twin {plain_ms:.4f} ms; "
                f"library (cuDNN conv, batch_norm_stats) {library_ms:.4f} ms; "
                f"host {host_us:.1f} us a call (the wrapper and its launches)")
            for key, v in (("ms", call_ms), ("loop", loop_ms), ("plain", plain_ms),
                           ("library", library_ms), ("bound", bound)):
                tot[key] += v
            tot["err"] = max(tot["err"], err)
            del x, w, b
            torch.cuda.empty_cache()
        log(f"[dsn-stats] {task} a contrast forward's three heads: {tot['ms']:.4f} ms per call, "
            f"{tot['loop']:.4f} ms back to back, bound {tot['bound']:.4f} ms, plain twin "
            f"{tot['plain']:.4f} ms, library {tot['library']:.4f} ms")
        rows.append(dict(name="dsn_stats" if task == "odoc" else f"dsn_stats[{task}]", route="cuda",
                         source="fedicra_torch/csrc/dsn_stats.cu",
                         replaces="none: fedicra_tpu/models/blocks.py DSNHead's pass 1 under jit",
                         launches=None, max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain"],
                         bound_ms=tot["bound"], bound_by="operations", library_ms=tot["library"]))
    return rows


def tree_differences(w_card: torch.Tensor, w_cpu: torch.Tensor, h: int, w: int) -> dict:
    """How the MSTs of one call's weights [N, E] on the card and on the CPU
    differ: the images and edges that differ, and the excess of the other
    device's tree over each device's own under that device's weights
    (float64, exact for these fp32 sums; 0 where the other tree is a
    minimum tree too, so that the two differ only by swaps of edges whose
    weights tie exactly there), with the largest gap between the weights."""
    from fedicra_torch.ops.mst import boruvka_mst, grid_edges

    eu, ev = (torch.as_tensor(a).long() for a in grid_edges(h, w))
    w_card, w_cpu = w_card.cpu(), w_cpu.cpu()
    sel_card, sel_cpu = (boruvka_mst(eu, ev, t, h * w) for t in (w_card, w_cpu))
    differ = (sel_card != sel_cpu).any(dim=1)

    def excess(weights, own, other):
        weights = weights.double()
        return ((weights * other).sum(1) - (weights * own).sum(1)).max().item()

    return {"images": int(differ.sum()), "edges": int((sel_card & ~sel_cpu).sum()),
            "excess_card": excess(w_card, sel_card, sel_cpu),
            "excess_cpu": excess(w_cpu, sel_cpu, sel_card),
            "max_weight_gap": (w_card - w_cpu).abs().max().item()}


def phase_small_agreement(dev):
    """The objective (tree term on), then ``treeenergy_add`` on the same
    weights, on the card against the CPU (plain twins). The launch counts
    show the route: the tree kernels and no plain filter on the card, the
    plain filter and no kernel on the CPU.

    The high trees' MSTs come from aux logits upsampled 4x, whose weights
    hold exact ties that each device's rounding breaks its own way, and a
    tie broken otherwise moves the gradient through the tree. So the CPU
    builds its trees from the card's MST weights, call for call, and the
    two devices are held to the same trees; the trees of the CPU's own
    weights are compared with the card's apart (``tree_differences``)."""
    from fedicra_torch.engine.config import TrainConfig
    from fedicra_torch.engine.objective import ours_loss, treeenergy_add_loss
    from fedicra_torch.engine.trainer import init_client_state
    from fedicra_torch.losses import tree_energy
    from fedicra_torch.models import net_factory

    cfg = TrainConfig.for_task("odoc", img_size=32, batch_size=2, tree_loss_weight=0.1)
    rng = np.random.default_rng(2)
    image = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    label = np.where(rng.uniform(size=(2, 32, 32)) < 0.7, 3, rng.integers(0, 3, (2, 32, 32)))
    own_weights = tree_energy.mst_edge_weights
    card_weights, cpu_weights = [], []

    def card_records(guides, eu, ev):
        card_weights.append(own_weights(guides, eu, ev))
        return card_weights[-1]

    def cpu_takes_the_cards(guides, eu, ev):
        cpu_weights.append(own_weights(guides, eu, ev))
        return card_weights[len(cpu_weights) - 1].to(cpu_weights[-1].device)

    results = {}
    for device in (dev, "cpu"):
        on_cpu = torch.device(device).type == "cpu"
        model = net_factory("unet_lc_multihead", in_chns=3, class_num=3,
                            dropout=(0.0,) * 5, dsn_dropout=0.0)
        init_client_state(model, cfg, seed=5, device=device)
        model.train()
        batch = {"image": torch.as_tensor(image, device=device),
                 "label": torch.as_tensor(label, device=device)}
        tree_energy.mst_edge_weights = cpu_takes_the_cards if on_cpu else card_records
        try:
            _reset_kernel_counts()
            loss, metrics = ours_loss(model, batch, 1, cfg)
            loss.backward()
            counts = {"ours": _kernel_counts()}
            _reset_kernel_counts()
            _, add = treeenergy_add_loss(model, batch, 1, cfg.replace(procedure="treeenergy_add"))
            counts["treeenergy_add"] = _kernel_counts()
        finally:
            tree_energy.mst_edge_weights = own_weights
        # on the CPU the four plain filters, forward and backward (treeenergy_add: forward)
        if on_cpu:
            want = {"ours": {**ZERO_COUNTS, "tree_filter_fwd": 4, "tree_filter_bwd": 4},
                    "treeenergy_add": {**ZERO_COUNTS, "tree_filter_fwd": 4}}
        else:
            want = {"ours": tree_on_counts(1),
                    "treeenergy_add": {**tree_on_counts(1, gated_crf=0), "tree_bwd": 0}}
        log(f"[small] launches on {device}: {counts}")
        if counts != want:
            raise AssertionError(f"launches on {device} {counts}, expected {want}")
        results[str(device)] = (
            {k: v.item() for k, v in metrics.items() if v.ndim == 0},
            model.decoder.out_conv.weight.grad.cpu(),
            {f"treeenergy_add {k}": v.item() for k, v in add.items()},
        )
    if len(cpu_weights) != len(card_weights):
        raise AssertionError(f"{len(card_weights)} MST calls on the card, {len(cpu_weights)} on the CPU")
    for call, (a, b) in zip(("ours", "treeenergy_add"), zip(card_weights, cpu_weights)):
        log(f"[small] {call}: the trees of each device's own MST weights differ in "
            f"{tree_differences(a, b, 32, 32)}")
    (m_cpu, g_cpu, a_cpu), (m_gpu, g_gpu, a_gpu) = results["cpu"], results[str(dev)]
    m_cpu, m_gpu = {**m_cpu, **a_cpu}, {**m_gpu, **a_gpu}
    if not m_gpu["loss_tree"] > 0.0:
        raise AssertionError(f"loss_tree {m_gpu['loss_tree']!r} at tree_loss_weight 0.1")
    for k in m_cpu:
        if not math.isclose(m_cpu[k], m_gpu[k], rel_tol=1e-4, abs_tol=1e-6):
            raise AssertionError(f"{k}: card {m_gpu[k]!r} vs cpu {m_cpu[k]!r}")
    torch.testing.assert_close(g_gpu, g_cpu, rtol=1e-3, atol=1e-5)
    log(f"[small] ours_loss card {m_gpu['total_loss']:.7g} cpu {m_cpu['total_loss']:.7g}, "
        f"loss_tree card {m_gpu['loss_tree']:.7g} cpu {m_cpu['loss_tree']:.7g}; "
        f"out_conv grad max |diff| {(g_gpu - g_cpu).abs().max().item():.3g}; treeenergy_add "
        f"card {m_gpu['treeenergy_add total_loss']:.7g} cpu {m_cpu['treeenergy_add total_loss']:.7g}")


def main_path_setup(dev, tree_loss_weight: float = 0.1, iters: int = 4, rep_iters: int = 2,
                    amp: bool = False, task: str = "odoc"):
    """The main path's workload: ``task`` (ODOC unless given) at full width
    and its own image size, channels, classes and clients, batch 12, by
    default at the default tree weight with 4 steps (2 head, 2 body), in
    fp32 unless ``amp``.

    Returns (cfg, cid, model, state, round_fn, batches); random weights from
    cfg.seed, smooth images and 95%-unlabelled scribbles from numpy seed 1.
    """
    from fedicra_torch.engine.config import TrainConfig
    from fedicra_torch.engine.trainer import init_client_state, make_round_fn
    from fedicra_torch.models import net_factory

    cfg = TrainConfig.for_task(
        task, procedure="ours", strategy="FedICRA", model="unet_lc_multihead",
        tree_loss_weight=tree_loss_weight, iters=iters, rep_iters=rep_iters, batch_size=BATCH,
        amp=amp,
    )
    cid = 1
    model = net_factory("unet_lc_multihead", in_chns=cfg.in_chns, class_num=cfg.num_classes,
                        num_clients=cfg.num_clients, client_id=cid)
    state = init_client_state(model, cfg, seed=cfg.seed, device=dev)
    round_fn = make_round_fn(model, cfg, device=dev)

    rng = np.random.default_rng(1)
    shape = (cfg.iters, cfg.batch_size, cfg.img_size, cfg.img_size)
    images = smooth_images(rng, cfg.iters * cfg.batch_size, cfg.img_size, cfg.img_size, cfg.in_chns)
    images = images.reshape(shape + (cfg.in_chns,))
    labels = rng.integers(0, cfg.num_classes, size=shape)
    labels = np.where(rng.uniform(size=shape) < 0.95, cfg.num_classes, labels)
    batches = {"image": torch.as_tensor(images, device=dev),
               "label": torch.as_tensor(labels, device=dev)}
    return cfg, cid, model, state, round_fn, batches


def dtype_probe(model):
    """Record one forward's dtypes: the model's outputs (a forward hook) and
    the input of every batch-norm op (``F.batch_norm`` wrapped). Returns
    (record, remove): ``record`` maps an output name, or "batch_norm input",
    to the set of dtypes seen; ``remove()`` undoes both."""
    import torch.nn.functional as F

    record: dict = {}
    batch_norm = F.batch_norm

    def seen(name, t):
        record.setdefault(name, set()).add(str(t.dtype).replace("torch.", ""))

    def hook(module, args, out):
        if "logits" in out:  # a contrast forward returns only features and heatmaps
            seen("logits", out["logits"])
        for key in ("features", "de", "aux"):
            for t in out.get(key, []):
                seen(key, t)
        for t in out.get("heatmaps", []):
            if t is not None:
                seen("heatmaps", t)

    def recording_batch_norm(x, *args, **kwargs):
        seen("batch_norm input", x)
        return batch_norm(x, *args, **kwargs)

    handle = model.register_forward_hook(hook)
    F.batch_norm = recording_batch_norm

    def remove():
        handle.remove()
        F.batch_norm = batch_norm

    return record, remove


def phase_round(dev, tag: str, treeenergy_add: bool = False, **setup):
    """One FedICRA round at full width; returns its launch counts, losses,
    step times and peak memory. Under ``amp=True`` it also records the
    dtypes of the first step's forwards and holds them to JAX's AMP. With
    ``treeenergy_add`` it then takes one step of that objective
    (``treeenergy_add_step``)."""
    from fedicra_torch.models.params_filters import is_dsn_head, is_head, is_pcs
    from fedicra_torch.ops import dsn_stats_cuda, gated_crf_cuda

    cfg, cid, model, state, round_fn, batches = main_path_setup(dev, **setup)
    iters, rep = cfg.iters, cfg.rep_iters
    tree_on = cfg.tree_loss_weight != 0.0
    n_params = sum(p.numel() for p in state.params.values())
    log(f"[{tag}] unet_lc_multihead {n_params} params; batches {tuple(batches['image'].shape)}; "
        f"cid {cid}; tree_loss_weight {cfg.tree_loss_weight}; amp {cfg.amp}; "
        f"{iters - rep} head + {rep} body steps")

    snaps, stamps = [], []
    dtypes, remove_probe = dtype_probe(model) if cfg.amp else ({}, None)

    def on_step(j, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if j == 0 and remove_probe is not None:
            remove_probe()
        if j == iters - rep - 1:
            snaps.append({n: p.detach().clone() for n, p in model.named_parameters()})

    generator_state = state.generator.get_state()  # replays step 1's draws for the plain route
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    dsn_stats_cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        new, metrics = round_fn(state, batches, cid, on_step=on_step)
    finally:
        if remove_probe is not None:
            remove_probe()
    torch.cuda.synchronize()
    counts = _kernel_counts()
    # 3 DSN heads in each of the K - 1 contrast forwards a step, none in the step's own forward
    dsn_launches = dsn_stats_cuda.launches["dsn_stats"]
    if dsn_launches != 3 * (cfg.num_clients - 1) * iters:
        raise AssertionError(f"[{tag}] {dsn_launches} DSN moment launches in {iters} steps, "
                             f"expected {3 * (cfg.num_clients - 1) * iters}")
    launches = {"gated_crf": counts["gated_crf"]}
    by_dtype = dict(gated_crf_cuda.launches_by_dtype)
    peak = torch.cuda.max_memory_allocated() / 2**30

    losses = metrics["total_loss"].float().cpu()
    steps = np.diff([t0] + stamps) * 1e3
    log(f"[{tag}] total_loss per step {losses.tolist()}")
    for k in ("loss_ce", "loss_tree", "loss_crf", "loss_lc"):
        log(f"[{tag}] {k} per step {metrics[k].float().cpu().tolist()} ({metrics[k].dtype})")
    log(f"[{tag}] step ms {[round(float(s), 3) for s in steps]}")
    log(f"[{tag}] max_memory_allocated {peak:.3f} GiB")
    log(f"[{tag}] kernel launches {counts} (gated CRF by y dtype {by_dtype}); "
        f"DSN moments {dsn_launches}")

    if losses.shape != (iters,) or not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite or misshapen losses {losses}")
    for k in ("loss_ce", "loss_tree", "loss_crf", "loss_lc"):
        if not torch.isfinite(metrics[k].float()).all():
            raise AssertionError(f"{k} not finite")
    if tree_on and not (metrics["loss_tree"] > 0).all():
        raise AssertionError(f"loss_tree {metrics['loss_tree'].tolist()} at weight {cfg.tree_loss_weight}")
    want = tree_on_counts(iters) if tree_on else {**ZERO_COUNTS, "gated_crf": iters}
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    want_dtype = "bfloat16" if cfg.amp else "float32"
    if by_dtype[want_dtype] != iters:
        raise AssertionError(f"expected {iters} gated-CRF launches on {want_dtype} y, got {by_dtype}")
    if tree_on and not cfg.amp:
        plain_route_first_step(model, state, generator_state, batches, cid, cfg,
                               metrics["loss_tree"][0].item(), tag)
    if cfg.amp:
        log(f"[{tag}] dtypes of step 1's forwards (own and contrast): "
            + "; ".join(f"{k} {sorted(v)}" for k, v in sorted(dtypes.items())))
        # JAX's AMP: bf16 logits and heatmap; fp32 features, decoder stages,
        # DSN aux, and every BatchNorm's input
        want = {"logits": {"bfloat16"}, "heatmaps": {"bfloat16"}, "features": {"float32"},
                "de": {"float32"}, "aux": {"float32"}, "batch_norm input": {"float32"}}
        if dtypes != want:
            raise AssertionError(f"AMP dtypes {dtypes}, expected {want}")
        if metrics["loss_ce"].dtype != torch.bfloat16 or metrics["total_loss"].dtype != torch.float32:
            raise AssertionError(f"AMP loss dtypes {metrics['loss_ce'].dtype}, {metrics['total_loss'].dtype}")
    before, after, head_end = state.params, new.params, snaps[0]
    for n in before:
        if is_pcs(n) and not torch.equal(before[n], after[n]):
            raise AssertionError(f"frozen PCS parameter {n} changed")
        if is_dsn_head(n) and torch.equal(before[n], after[n]) == tree_on:
            raise AssertionError(f"DSN parameter {n}: moved={not tree_on} over the round, "
                                 f"tree_loss_weight {cfg.tree_loss_weight}")
        if before[n].dtype != torch.float32 or after[n].dtype != torch.float32:
            raise AssertionError(f"parameter {n} is not fp32")
        moved = not torch.equal(before[n], head_end[n])
        if moved != is_head(n):
            raise AssertionError(f"head phase: {n} moved={moved}")
    if new.current_iter != iters:
        raise AssertionError(f"current_iter {new.current_iter}")
    if treeenergy_add:
        treeenergy_add_step(dev, model, state, batches, cid, cfg)
    return dict(launches={**counts, "dsn_stats": dsn_launches}, losses=losses.tolist(),
                steps=[float(x) for x in steps], peak=peak)


def plain_route_first_step(model, state, generator_state, batches, cid: int, cfg,
                           loss_tree: float, tag: str) -> None:
    """The round's first forward again, from its weights and dropout draws,
    and its tree term on the plain route (``host_offload=False``: PyTorch
    ops, DFS-ordered filters); that ``loss_tree`` against the round's (the
    kernel route's) at rtol 1e-4."""
    from fedicra_torch.engine.objective import _forward, _tree_loss

    model.load_state_dict({**state.params, **state.batch_stats})
    model.train()
    generator = torch.Generator(device=state.generator.device)
    generator.set_state(generator_state)
    images, labels = batches["image"][0].float(), batches["label"][0].long()
    _reset_kernel_counts()
    with torch.no_grad():
        out = _forward(model, images, cid, cfg, generator)
        loss = _tree_loss(out, images, labels, cfg, recursive=True, host_offload=False)
    plain = loss.item()
    counts = _kernel_counts()
    rel = abs(plain - loss_tree) / abs(plain)
    log(f"[{tag}] step 1 loss_tree: kernel route {loss_tree!r}, plain route {plain!r} "
        f"(relative gap {rel:.3g}); plain route's launches {counts}")
    if counts != {**ZERO_COUNTS, "tree_filter_fwd": 4}:
        raise AssertionError(f"plain-route tree term launched {counts}")
    if not math.isclose(plain, loss_tree, rel_tol=1e-4):
        raise AssertionError(f"step 1 loss_tree {loss_tree!r} on the kernel route, {plain!r} on the plain")


def treeenergy_add_step(dev, model, state, batches, cid: int, cfg) -> None:
    """One step of the ``treeenergy_add`` objective (pCE + the additive
    multi-scale tree term, no gated CRF, no contrast term) at the main
    path's shape, from the round's starting weights and first batch: finite
    losses and gradients, the tree term above 0, and one low and three high
    tree filters forward and backward. (``phase_small_agreement`` holds the
    objective on the card to the CPU.)"""
    from fedicra_torch.engine.objective import treeenergy_add_loss

    model.load_state_dict({**state.params, **state.batch_stats})
    model.train()
    model.zero_grad(set_to_none=True)
    batch = {"image": batches["image"][0].float(), "label": batches["label"][0].long()}
    _reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, metrics = treeenergy_add_loss(model, batch, cid, cfg.replace(procedure="treeenergy_add"),
                                        torch.Generator(device=dev).manual_seed(0))
    loss.backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _kernel_counts()
    values = {k: v.item() for k, v in metrics.items()}
    log(f"[main] treeenergy_add step: {1e3 * seconds:.3f} ms (forward and backward); "
        f"{ {k: round(v, 7) for k, v in values.items()} }; kernel launches {counts}")
    if not all(math.isfinite(v) for v in values.values()) or not values["loss_tree"] > 0:
        raise AssertionError(f"treeenergy_add losses {values}")
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads or not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError("treeenergy_add: missing or non-finite gradients")
    want = tree_on_counts(1, gated_crf=0)
    if counts != want:
        raise AssertionError(f"treeenergy_add launches {counts}, expected {want}")


def phase_main_amp(dev, fp32: dict) -> dict:
    """The main path under AMP, held to the fp32 main path's first loss
    (same weights, batches and dropout draws) within 5%."""
    amp = phase_round(dev, "main-amp", amp=True)
    first, first32 = amp["losses"][0], fp32["losses"][0]
    rel = abs(first - first32) / abs(first32)
    log(f"[main-amp] vs [main]: first total_loss {first:.7g} vs {first32:.7g} ({100 * rel:.3f}%); "
        f"step ms {[round(x, 3) for x in amp['steps']]} vs {[round(x, 3) for x in fp32['steps']]}; "
        f"max_memory_allocated {amp['peak']:.3f} vs {fp32['peak']:.3f} GiB")
    if rel > 0.05:
        raise AssertionError(f"AMP first loss {first!r} is {100 * rel:.2f}% from fp32's {first32!r}")
    return amp


def federation_config(img: int = None, batch: int = BATCH, task: str = "odoc"):
    """The federation phase's configuration: FedICRA "ours" for ``task``
    (ODOC unless given) at full width, the task's clients (ODOC 5), its image
    size unless ``img``, 2 local steps a round (1 head, 1 body), ALA from
    iteration 3 on (the reference waits until 51), evaluation at iteration 4.

    Not ``eval_iters=2``: an evaluate runs the client's whole set_weights
    (the reference's), so at iteration 2, where ALA is still skipped, each
    client would adopt the global weights, and round 2's fit would find
    them equal to its own and skip ALA too."""
    from fedicra_torch.engine.config import TrainConfig

    size = {} if img is None else {"img_size": img}
    return TrainConfig.for_task(
        task, procedure="ours", strategy="FedICRA", model="unet_lc_multihead",
        batch_size=batch, iters=2, rep_iters=1, eval_iters=4, ala_skip_iters=2, **size,
    )


def phase_federation(dev, snap: str, img: int = None, batch: int = BATCH, limit: int = 12,
                     task: str = "odoc") -> list:
    """Two federated rounds of ``task`` (ODOC unless given; its synthetic
    clients of its supervision types) through build_experiment and
    FederatedServer.run; returns each round's total_loss per client.

    Round 1 (iteration 2): every client adopts the global weights (they equal
    its own), trains 2 steps; the server averages. Round 2 (iteration 4):
    each client's ALA merge runs its first-run loop (>= 11 epochs), it trains,
    and the evaluation merges once more (1 epoch) and validates. Then a fresh
    experiment on the same snapshot directory resumes from it. The
    snapshot directory ``snap`` is the caller's. Logs as ``[federation]``
    for ODOC and ``[tasks <task> federation]`` for the others."""
    from fedicra_torch.engine.config import TASKS
    from fedicra_torch.federation import build_experiment
    from fedicra_torch.models.params_filters import is_ala_gated

    cfg = federation_config(img, batch, task)
    K, img = cfg.num_clients, cfg.img_size
    p = "[federation]" if task == "odoc" else f"[tasks {task} federation]"
    server = build_experiment(cfg, synthetic=True, limit_per_client=limit, snapshot_dir=snap,
                              device=dev)
    log(f"{p} {K} clients ({', '.join(TASKS[task]['sup_types'].values())}), {img}^2 x {cfg.in_chns}, "
        f"{cfg.num_classes} classes, batch {batch}, "
        f"train/val images per client {len(server.clients[0].batcher.split)}/"
        f"{len(server.clients[0].val_split)}; iters {cfg.iters} (rep {cfg.rep_iters}), "
        f"eval_iters {cfg.eval_iters}, ala_skip_iters {cfg.ala_skip_iters}")
    fits, evals = [], []  # per call: (iteration, cid, seconds, ALA report[, FitRes])

    def synced(fn):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for c in server.clients:
        def fit(ins, _c=c, _fit=c.fit):
            res, dt = synced(lambda: _fit(ins))
            fits.append((ins.config["iter_global"], _c.cid, dt, dict(_c.ala_report), res))
            return res

        def evaluate(ins, _c=c, _evaluate=c.evaluate):
            res, dt = synced(lambda: _evaluate(ins))
            evals.append((ins.config["iter_global"], _c.cid, dt, dict(_c.ala_report)))
            return res

        c.fit, c.evaluate = fit, evaluate

    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    history, wall = synced(lambda: server.run(num_rounds=2 * cfg.iters, progress=False))
    counts = _kernel_counts()

    for rec in history:
        log(f"{p} round at iteration {rec['round']}: {rec['round_duration']:.3f} s; "
            f"total_loss per client {[round(rec[f'client_{c}_total_loss'], 6) for c in range(K)]}")
    log(f"{p} run {wall:.3f} s")
    for it, cid, dt, rep, _ in fits:
        ala = (f"ALA {rep['epochs']} epochs in {rep['seconds']:.3f} s, gate mean "
               f"{rep['gate_mean']:.6f}" if rep else "ALA skipped")
        log(f"{p} fit iteration {it} client {cid}: {dt:.3f} s ({ala})")
    for it, cid, dt, rep in evals:
        ala = (f"ALA {rep['epochs']} epoch(s) in {rep['seconds']:.3f} s, gate mean "
               f"{rep['gate_mean']:.6f}" if rep else "ALA skipped")
        log(f"{p} evaluate iteration {it} client {cid}: {dt:.3f} s ({ala})")
    # the run's wall time by activity: local training (fit less its ALA),
    # ALA (in fit and evaluate), evaluation (evaluate less its ALA), and
    # the rest (aggregation, logging, checkpoints)
    reps = [f[3] for f in fits] + [e[3] for e in evals]
    ala_fit = sum(f[3].get("seconds", 0.0) for f in fits)
    ala_eval = sum(e[3].get("seconds", 0.0) for e in evals)
    epochs = sum(rep.get("epochs", 0) for rep in reps)
    parts = {"local training": sum(f[2] for f in fits) - ala_fit, "ALA": ala_fit + ala_eval,
             "evaluation": sum(e[2] for e in evals) - ala_eval}
    parts["other"] = wall - sum(parts.values())
    log(f"{p} share of the run: " + ", ".join(
        f"{k} {v:.3f} s ({100 * v / wall:.2f}%)" for k, v in parts.items())
        + f"; ALA {epochs} epochs, {1000 * parts['ALA'] / max(epochs, 1):.1f} ms each")
    final = history[-1]
    for c in range(K):
        log(f"{p} client {c}: val_mean_dice {final[f'client_{c}_val_mean_dice']:.6f} "
            f"val_mean_hd95 {final[f'client_{c}_val_mean_hd95']:.6f}")
    log(f"{p} aggregate: val_mean_dice {final['val_mean_dice']:.6f} "
        f"val_mean_hd95 {final['val_mean_hd95']:.6f} (by val size), val_avg_mean_dice "
        f"{final['val_avg_mean_dice']:.6f}")
    if torch.cuda.is_available():
        log(f"{p} max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"{p} kernel launches {counts}")

    # ALA: skipped in round 1, the first-run loop in round 2's fit, one
    # epoch at its evaluate
    for it, cid, _, rep, _ in fits:
        if it == cfg.iters and rep:
            raise AssertionError(f"client {cid}: ALA ran in round 1 ({rep['epochs']} epochs)")
        if it == 2 * cfg.iters and not (rep and 11 <= rep["epochs"] <= 50):
            raise AssertionError(f"client {cid}: round 2's fit ran ALA {rep.get('epochs')} epochs")
    epochs = [(it, rep.get("epochs")) for it, _, _, rep in evals]
    if epochs != [(2 * cfg.iters, 1)] * K:
        raise AssertionError(f"evaluate's ALA epochs by iteration {epochs}")
    if [c.start_phase for c in server.clients] != [False] * K:
        raise AssertionError("start_phase still set after ALA's first run")

    # the global payload is the weighted mean of round 2's fit payloads,
    # recomputed here in float64
    last = [f for f in fits if f[0] == 2 * cfg.iters]
    weights = torch.tensor([float(f[4].num_examples) for f in last], dtype=torch.float64)
    weights /= weights.sum()
    for part, tree in server.global_payload.items():
        for name, got in tree.items():
            want = sum(w * f[4].payload[part][name].double() for w, f in zip(weights, last))
            torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-7)

    # the evaluated clients: global weights below, gated ones between
    # the global and the client's own fit result
    glob = server.global_payload["params"]
    for c, (*_, res) in zip(server.clients, last):
        for name, value in c.state.params.items():
            if not is_ala_gated(name):
                if not torch.equal(value, glob[name]):
                    raise AssertionError(f"client {c.cid}: non-gated {name} is not the global value")
                continue
            own = res.payload["params"][name]
            lo, hi = torch.minimum(glob[name], own), torch.maximum(glob[name], own)
            if not ((value >= lo - 1e-6) & (value <= hi + 1e-6)).all():
                raise AssertionError(f"client {c.cid}: gated {name} outside [global, local]")

    nonfinite = {k: v for k, v in final.items()
                 if isinstance(v, float) and "val_" in k and not math.isfinite(v)}
    log(f"{p} non-finite metrics: {len(nonfinite)} {sorted(nonfinite)}")
    if any("hd95" not in k for k in nonfinite):
        raise AssertionError(f"non-finite metrics besides hd95: {nonfinite}")
    for rec in history:
        for k, v in rec.items():
            if "loss" in k and isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{k} = {v}")

    # a client writes best_client_{cid} when its own val_mean_dice beats
    # 0 (the reference's rule), the server best_global when the weighted
    # mean does; under ODOC at least one client must have written its own
    # (a 2-class task's val dice may still be 0 everywhere after 2 rounds)
    wrote = {n: os.path.exists(os.path.join(snap, n))
             for n in ["metrics.jsonl", "best_global"] + [f"best_client_{c}" for c in range(K)]}
    log(f"{p} snapshot files {wrote}")
    expect = {"metrics.jsonl": True, "best_global": final["val_mean_dice"] > 0,
              **{f"best_client_{c}": final[f"client_{c}_val_mean_dice"] > 0 for c in range(K)}}
    if wrote != expect or (task == "odoc" and not any(wrote[f"best_client_{c}"] for c in range(K))):
        raise AssertionError(f"snapshot files {wrote}, expected {expect}")

    server.ckpt.save_resume(server._resume_state())
    again = build_experiment(cfg, synthetic=True, limit_per_client=limit, snapshot_dir=snap,
                             device=dev)
    if not again.try_resume() or again.current_round != server.current_round:
        raise AssertionError(f"resume: round {again.current_round} vs {server.current_round}")
    for a, b in zip(again.clients, server.clients):
        if a.start_phase != b.start_phase or a.state.current_iter != b.state.current_iter:
            raise AssertionError(f"resume: client {a.cid}'s start_phase or iteration differs")
        if not all(torch.equal(a.state.params[k], v) for k, v in b.state.params.items()):
            raise AssertionError(f"resume: client {a.cid}'s weights differ")
    log(f"{p} resumed at iteration {again.current_round}; start_phase "
        f"{[c.start_phase for c in again.clients]}")

    n_steps = cfg.num_clients * 2 * cfg.iters
    if counts != tree_on_counts(n_steps):
        raise AssertionError(f"launches {counts}, expected {tree_on_counts(n_steps)}")
    losses = [[rec[f"client_{c}_total_loss"] for c in range(K)] for rec in history]
    del server, again
    torch.cuda.empty_cache()
    return losses


def federation_fedadam(dev, fed_cfg, limit: int) -> None:
    """One FedAdam round at reduced depth: 2 clients x 1 step of "ours" at
    the federation phase's width (FedAdam is not personalised: no ALA, no
    contrast term). Its global payload, both parts, against FedAdam's update
    recomputed in float64 from the clients' fit payloads (flwr's defaults,
    moments from zero): x + eta * m / (sqrt(v) + tau), at rtol 1e-5 wherever
    the weighted mean moved by more than 1e-4, and within eta everywhere."""
    from fedicra_torch.federation import build_experiment

    cfg = fed_cfg.replace(strategy="FedAdam", num_clients=2, iters=1, rep_iters=1, eval_iters=2)
    server = build_experiment(cfg, synthetic=True, limit_per_client=limit, device=dev)
    start = {part: {k: v.clone() for k, v in tree.items()}
             for part, tree in server.global_payload.items()}
    fits = []
    for c in server.clients:
        def fit(ins, _fit=c.fit):
            res = _fit(ins)
            fits.append(res)
            return res

        c.fit = fit
    _reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = server.run(num_rounds=cfg.iters, progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _kernel_counts()
    losses = [history[-1][f"client_{c}_total_loss"] for c in range(2)]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"FedAdam round: non-finite losses {losses}")
    s = server.strategy
    weights = torch.tensor([float(f.num_examples) for f in fits], dtype=torch.float64)
    weights /= weights.sum()
    worst, held, total = 0.0, 0, 0
    for part, tree in server.global_payload.items():
        for name, got in tree.items():
            x, got = start[part][name].double(), got.double()
            delta = sum(w * f.payload[part][name].double() for w, f in zip(weights, fits)) - x
            m, v = (1 - s.beta_1) * delta, (1 - s.beta_2) * delta * delta
            want = x + s.eta * m / (torch.sqrt(v) + s.tau)
            # the step is eta * d / (|d| + 1e-8): ill-conditioned where the
            # mean moved by little more than float32 resolves on x
            sure = delta.abs() > 1e-4
            torch.testing.assert_close(got[sure], want[sure], rtol=1e-5, atol=1e-6)
            if not ((got - x).abs() <= s.eta * (1 + 1e-5)).all():
                raise AssertionError(f"FedAdam moved {part}/{name} by more than eta")
            if sure.any():
                worst = max(worst, (got[sure] - want[sure]).abs().max().item())
            held += int(sure.sum())
            total += sure.numel()
    log(f"[federation] FedAdam round (2 clients x 1 step): {seconds:.3f} s; total_loss "
        f"{[round(v, 6) for v in losses]}; global payload against float64 FedAdam, max |diff| "
        f"{worst:.3g} on the {held} of {total} elements whose mean moved by > 1e-4, the rest "
        f"within eta; kernel launches {counts}")
    if counts != tree_on_counts(2):
        raise AssertionError(f"FedAdam round launches {counts}, expected {tree_on_counts(2)}")
    del server


def _sharded_rank(rank: int, device: str, cfg, limit: int, out: str) -> None:
    """A rank of ``phase_sharded``'s (ii) and (iii): the sharded federation's
    first round on this rank's mesh, its first step's loss and BatchNorm
    statistics per client, the round's global payload, its wall time, peak
    memory and kernel launches, saved to ``out.<rank>``."""
    import torch.distributed as dist

    from fedicra_torch.federation.sharded_experiment import ShardedFederation

    full_fp32()  # as this script's main process
    fed = ShardedFederation(cfg, synthetic=True, limit_per_client=limit, device=device)
    first, stamps = {}, []

    def on_step(cid, j, metrics):
        if j == 0:
            first[cid] = (metrics["total_loss"].item(),  # waits for the step
                          {n: b.detach().cpu().clone() for n, b in fed.model.named_buffers()})
        stamps.append(time.perf_counter())

    card = fed.device.type == "cuda"  # a CPU rank in a rehearsal of this phase
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    record = fed.run_round(on_step=on_step)
    if card:
        torch.cuda.synchronize()
    torch.save(dict(mesh=fed.mesh.shape, coords=fed.mesh.coords, backend=dist.get_backend(),
                    device=str(fed.device), seconds=time.perf_counter() - t0,
                    steps=[b - a for a, b in zip([t0, *stamps], stamps)],
                    peak=torch.cuda.max_memory_allocated() / 2**30 if card else 0.0,
                    launches=_kernel_counts(), first=first, record=record,
                    payload=cpu_payload(fed.global_payload)), f"{out}.{rank}")


def cpu_payload(payload: dict) -> dict:
    return {part: {k: v.detach().cpu().clone() for k, v in tree.items()}
            for part, tree in payload.items()}


def one_round_payload(dev, cfg, limit: int) -> dict:
    """The global payload after the sharded federation's first round on mesh
    (1, 1), in this process."""
    from fedicra_torch.federation.sharded_experiment import ShardedFederation

    fed = ShardedFederation(cfg, synthetic=True, limit_per_client=limit, device=dev)
    fed.run_round()
    payload = cpu_payload(fed.global_payload)
    del fed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return payload


def hold_payloads(tag: str, ranks: list, want: dict, cfg) -> None:
    """The round's global payload on every rank against (1, 1)'s ``want``,
    after one local step a client: the ranks equal bit for bit; the
    BatchNorm statistics at atol 5e-5 + rtol 5e-5; the weights within one
    Adam step's envelope (2 lr: a gradient of rounding noise turns into a
    step of +-lr) with each tensor's median element at 1e-6, but for the conv
    biases before a BatchNorm and the DSN heads, whose gradients are such
    noise, held to the envelope only (as tests/test_torch_sharded_data.py)."""
    from fedicra_torch.engine.trainer import poly_lr

    got = ranks[0]["payload"]
    for r, res in enumerate(ranks):
        for part, tree in res["payload"].items():
            if any(not torch.equal(v, got[part][k]) for k, v in tree.items()):
                raise AssertionError(f"{tag}: rank {r}'s global {part} differs from rank 0's")
    worst_stat = 0.0
    for k, w in want["batch_stats"].items():
        torch.testing.assert_close(got["batch_stats"][k], w, rtol=5e-5, atol=5e-5,
                                   msg=lambda m, _k=k: f"{tag} global {_k}: {m}")
        worst_stat = max(worst_stat, (got["batch_stats"][k] - w).abs().max().item())
    envelope = 2 * poly_lr(cfg.base_lr, 0, cfg.max_iterations)
    worst = worst_median = 0.0
    for k, w in want["params"].items():
        d = (got["params"][k] - w).abs().flatten()
        worst = max(worst, d.max().item())
        if d.max().item() > envelope:
            raise AssertionError(f"{tag} global {k}: max |diff| {d.max().item():.3g} > {envelope}")
        if not (k.endswith(".conv.bias") or ".dsn_head" in k):
            median = d.median().item()
            worst_median = max(worst_median, median)
            if median > 1e-6:
                raise AssertionError(f"{tag} global {k}: median |diff| {median:.3g} > 1e-6")
    log(f"[sharded] {tag} global payload against (1, 1)'s: ranks equal; BatchNorm statistics "
        f"max |diff| {worst_stat:.3g}; weights max |diff| {worst:.3g} (envelope {envelope:.3g}), "
        f"largest median {worst_median:.3g}")


def _sharded_ranks(cfg, limit: int, backend: str, devices: list) -> list:
    from fedicra_torch.parallel import spawn_ranks

    with tempfile.TemporaryDirectory(prefix="fedicra_sharded_") as tmp:
        out = os.path.join(tmp, "rank")
        t0 = time.perf_counter()
        spawn_ranks(_sharded_rank, (cfg, limit, out), backend, devices)
        wall = time.perf_counter() - t0
        ranks = [torch.load(f"{out}.{r}") for r in range(len(devices))]
    log(f"[sharded] {len(devices)} ranks over {backend} on {devices}: mesh {ranks[0]['mesh']}, "
        f"launch {wall:.3f} s (process start-up and first use of the card included)")
    for r, res in enumerate(ranks):
        log(f"[sharded] rank {r} at {res['coords']} ({res['backend']}, {res['device']}): first "
            f"round {res['seconds']:.3f} s, its steps {[round(t, 3) for t in res['steps']]} s "
            f"(the first with the process's first use of each kernel); max_memory_allocated {res['peak']:.3f} GiB; kernel "
            f"launches {res['launches']}; first-step total_loss "
            f"{ {c: round(v[0], 7) for c, v in sorted(res['first'].items())} }")
    return ranks


def hold_first_steps(tag: str, ranks: list, first: dict, mesh: tuple, cfg) -> None:
    """Each rank of a (1, n) mesh holds every client: its first step per
    client against (1, 1)'s ``first``, the loss at rtol 1e-4, the BatchNorm
    statistics at atol 5e-5 + rtol 5e-5; every rank's record the same."""
    worst_loss = worst_stat = 0.0
    for res in ranks:
        held = sorted(res["first"])
        if res["mesh"] != mesh or held != list(range(cfg.num_clients)):
            raise AssertionError(f"{tag}: mesh {res['mesh']}, clients {held}")
        if res["launches"] != tree_on_counts(len(held) * cfg.iters):
            raise AssertionError(f"{tag}: launches {res['launches']}, expected "
                                 f"{tree_on_counts(len(held) * cfg.iters)}")
        for c, (loss, stats) in res["first"].items():
            loss0, stats0 = first[c]
            worst_loss = max(worst_loss, abs(loss - loss0) / abs(loss0))
            if not math.isclose(loss, loss0, rel_tol=1e-4):
                raise AssertionError(f"{tag} client {c}: first-step loss {loss!r} vs {loss0!r}")
            for n, b in stats.items():
                torch.testing.assert_close(b, stats0[n], rtol=5e-5, atol=5e-5,
                                           msg=lambda m, _n=n, _c=c: f"{tag} client {_c} {_n}: {m}")
                worst_stat = max(worst_stat, (b - stats0[n]).abs().max().item())
    if any(res["record"] != ranks[0]["record"] for res in ranks):
        raise AssertionError(f"{tag}: the ranks' records differ")
    log(f"[sharded] {tag} against (i): first-step loss relative gap {worst_loss:.3g}, BatchNorm "
        f"statistics max |diff| {worst_stat:.3g}")


def phase_sharded(dev, in_process_losses: list, img: int = IMG, batch: int = BATCH,
                  limit: int = 12) -> dict:
    """The SPMD federation (``--sharded``'s library route) on the card.

    (i) Mesh (1, 1), in this process: ``ShardedFederation.run`` for the
    federation phase's 2 rounds (5 full-width ODOC clients, FedICRA "ours"
    at tree weight 0.1, 2 steps a round, ALA's first-run loop in round 2,
    evaluation at iteration 4), from the same weights and batches; each
    round's losses within rtol 1e-3 of ``phase_federation``'s (the card's
    backward adds in no fixed order). Prints the round wall times, the ALA
    epochs per client, the peak memory and the launches.
    (ii) Mesh (1, 2): two gloo ranks on this card (NCCL refuses two ranks on
    one device), batch 6 each, a first round of one step a client; each
    client's first-step loss (rtol 1e-4) and BatchNorm statistics (atol 5e-5
    + rtol 5e-5) against (i)'s, the two ranks equal; the round's global
    payload, after the data group's gradient all-reduce, the AdamW step and
    the FedAvg all-reduce, against the same one-step round on (1, 1) in this
    process (``hold_payloads``).
    (iii) With n >= 2 cards, over NCCL: the mesh of every card (5 clients:
    (1, n)) held to (i) and (1, 1) as (ii) is, and mesh (2, 1) with 4
    clients, finite losses and the payload held to its (1, 1) round; else it
    says it did not run."""
    from fedicra_torch.federation.sharded_experiment import ShardedFederation

    cfg = federation_config(img, batch)
    fed = ShardedFederation(cfg, synthetic=True, limit_per_client=limit, device=dev)
    first = {}
    inner = fed.round_fn

    def round_fn(*args, **kwargs):  # records round 1's first step
        def on_step(cid, j, metrics):
            if j == 0 and fed.current_round == 0:
                first[cid] = (metrics["total_loss"].item(),
                              {n: b.detach().cpu().clone() for n, b in fed.model.named_buffers()})
        return inner(*args, **{**kwargs, "on_step": on_step})

    fed.round_fn = round_fn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    history = fed.run(num_rounds=2 * cfg.iters, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_steps = cfg.num_clients * 2 * cfg.iters
    log(f"[sharded] (i) mesh {fed.mesh.shape}: {len(history)} rounds in {wall:.3f} s, round wall "
        f"{[round(r['round_duration'], 3) for r in history]} s (round 2 with ALA's first run "
        f"and the evaluation); ALA epochs per client {[fed.ala_counters[c] for c in range(5)]}; "
        f"max_memory_allocated {peak:.3f} GiB; kernel launches {counts}")
    gaps = []
    for rnd, (rec, want) in enumerate(zip(history, in_process_losses), 1):
        got = [rec[f"client_{c}_total_loss"] for c in range(5)]
        gaps += [abs(g - w) / abs(w) for g, w in zip(got, want)]
        log(f"[sharded] (i) round {rnd} total_loss {[round(v, 7) for v in got]}; in-process "
            f"{[round(v, 7) for v in want]}")
    log(f"[sharded] (i) largest relative gap to the in-process route {max(gaps):.3g}; "
        f"val_mean_dice {history[-1]['val_mean_dice']:.6f}")
    if len(history) != 2 or max(gaps) > 1e-3:
        raise AssertionError(f"sharded losses {max(gaps):.3g} from the in-process route's")
    if not all(11 <= fed.ala_counters[c] <= 50 for c in range(5)):
        raise AssertionError(f"ALA's first run drew {fed.ala_counters} epochs")
    if counts != tree_on_counts(n_steps):
        raise AssertionError(f"sharded launches {counts}, expected {tree_on_counts(n_steps)}")
    if not math.isfinite(history[-1]["val_mean_dice"]):
        raise AssertionError("sharded val_mean_dice not finite")
    del fed, inner
    torch.cuda.empty_cache()

    cards = ["cuda:0"] * 2 if dev.type == "cuda" else ["cpu"] * 2
    # one step a client: its forward, the one compared, is the first step's
    # whatever phase it opens
    one_step = cfg.replace(iters=1, rep_iters=1)
    t0 = time.perf_counter()
    want = one_round_payload(dev, one_step, limit)
    log(f"[sharded] (1, 1) one-step round in this process, for the payload: "
        f"{time.perf_counter() - t0:.3f} s")
    ranks = _sharded_ranks(one_step, limit, "gloo", cards)
    hold_first_steps("(ii)", ranks, first, (1, 2), one_step)
    hold_payloads("(ii)", ranks, want, one_step)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        # every card over NCCL: 5 clients give (1, n) for n = 2, 3, 4
        cards = [f"cuda:{i}" for i in range(n_cards)]
        ranks = _sharded_ranks(one_step, limit, "nccl", cards)
        hold_first_steps("(iii)", ranks, first, ranks[0]["mesh"], one_step)
        hold_payloads("(iii)", ranks, want, one_step)
        four = one_step.replace(num_clients=4)
        ranks = _sharded_ranks(four, limit, "nccl", cards[:2])
        losses = [v for res in ranks for v, _ in res["first"].values()]
        if ranks[0]["mesh"] != (2, 1) or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"(iii): mesh {ranks[0]['mesh']}, losses {losses}")
        hold_payloads("(iii) (2, 1)", ranks, one_round_payload(dev, four, limit), four)
    else:
        log(f"[sharded] (iii) NCCL meshes over cards not run: {n_cards} card")
    return dict(rounds=[r["round_duration"] for r in history], wall=wall, peak=peak,
                launches=counts["gated_crf"])


def task_gated_crf(dev, task: str) -> dict:
    """The fused gated-CRF kernel at ``task``'s step shape (``[tasks]``):
    batch 12, its classes, its image size, F = 2 + its channels (FAZ 12 x 2
    x 256^2, F = 3; Polyp 12 x 2 x 384^2, F = 5), r = 5, on present and
    confident inputs against its twins (``hold_gated_crf``); its time per
    call and back to back beside its twin's and ``gated_crf_work``'s bound.
    Returns the JSON row ``gated_crf[task]``; its launches are the task's
    round's."""
    from fedicra_torch.engine.config import TASKS
    from fedicra_torch.ops import gated_crf_cuda as g

    table = TASKS[task]
    b, c, h, w, r = BATCH, table["num_classes"], table["img_size"], table["img_size"], 5
    prefix = f"[tasks {task}]"
    f, inputs = gated_crf_inputs(dev, np.random.default_rng(10), b, c, h, w, table["in_chns"])
    errs = []
    for tag, y in inputs.items():
        errs += hold_gated_crf(f"{prefix} gated_crf", tag, y, f, r)
    y = inputs["present"]
    call_ms = cuda_median_ms(lambda: g.gated_crf_fused_cuda(y, f, r))
    loop_ms = cuda_loop_ms(lambda: g.gated_crf_fused_cuda(y, f, r))
    plain_ms = cuda_median_ms(lambda: g.gated_crf_potts_fused_plain(y, f, r), reps=10)
    ops, exps = gated_crf_work(b, c, f.shape[1], h, w, r)
    bound, by = bound_ms(ops, 4 * (2 * y.numel() + f.numel()))  # y + f read, acc written
    log(f"{prefix} gated_crf at B={b}, C={c}, F={f.shape[1]}, {h}^2, r={r}: fused pass {call_ms:.4f} "
        f"ms per call, {loop_ms:.4f} ms back to back; plain twin {plain_ms:.4f} ms; bound "
        f"{bound:.4f} ms ({by}: {ops} fp32 operations; {exps} exps apart)")
    return dict(name=f"gated_crf[{task}]", route="cuda", source="fedicra_torch/csrc/gated_crf.cu",
                replaces="fedicra_tpu/ops/gated_crf_pallas.py:77 and :106",
                max_abs_err=max(errs), ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def phase_tasks(dev) -> list:
    """FedICRA "ours" at the FAZ and the Polyp configuration (``[tasks]``):
    for each, at the task's own image size, channels, classes and clients,
    batch 12, ``unet_lc_multihead``, tree_loss_weight 0.1, fp32:
    1. the gated-CRF kernel against its twins at the step's shape
       (``task_gated_crf``);
    2. the tree chain's four kernels on one step's four trees
       (``tree_kernels_step``);
    3. a local round of 4 steps (2 head, 2 body) through ``make_round_fn``
       (``phase_round``): finite losses, step ms, peak memory, launches 4 /
       4 / 4 / 16 / 16 and no plain filter, the first step's loss_tree
       against the plain route's at rtol 1e-4;
    4. 2 federated rounds of the task's synthetic clients
       (``phase_federation``): ALA's first-run loop in round 2, the
       evaluation, finite losses and metrics (hd95 aside) for every client.
    Returns the five kernels' JSON rows of each task, their launches the
    task's round's."""
    from fedicra_torch.engine.config import TASKS

    rows = []
    for task in ("faz", "polyp"):
        t0 = time.perf_counter()
        kernels = [task_gated_crf(dev, task)]
        torch.cuda.empty_cache()
        table = TASKS[task]
        step = tree_kernels_step(dev, f"[tasks {task}]", np.random.default_rng(6), BATCH,
                                 table["img_size"], table["img_size"], table["num_classes"],
                                 table["in_chns"])
        kernels += tree_rows(f"[tasks {task}]", step.times, step.errs, step.work, step.chain,
                             f"[{task}]")
        del step
        torch.cuda.empty_cache()
        run = phase_round(dev, f"tasks {task}", task=task)
        for row in kernels:
            row["launches"] = run["launches"][row["name"].split("[")[0]]
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix=f"fedicra_{task}_") as tmp:
            phase_federation(dev, os.path.join(tmp, "federation"), task=task)
        torch.cuda.empty_cache()
        log(f"[tasks {task}] phase {time.perf_counter() - t0:.3f} s")
        rows += kernels
    return rows


def _kernel_counts() -> dict:
    """Every kernel's launches, and the plain tree filter's runs."""
    from fedicra_torch.ops import gated_crf_cuda, gaussian_filter_cuda, tree_filter, tree_filter_cuda

    return {**gated_crf_cuda.launches, **gaussian_filter_cuda.launches,
            **tree_filter_cuda.launches, **tree_filter.calls}


def _reset_kernel_counts() -> None:
    from fedicra_torch.ops import gated_crf_cuda, gaussian_filter_cuda, tree_filter, tree_filter_cuda

    gated_crf_cuda.reset_launches()
    gaussian_filter_cuda.reset_launches()
    tree_filter_cuda.reset_launches()
    tree_filter.reset_calls()


ZERO_COUNTS = {"gated_crf": 0, "gaussian_filter": 0, "tree_mst": 0, "tree_root": 0,
               "tree_fwd": 0, "tree_bwd": 0, "tree_filter_fwd": 0, "tree_filter_bwd": 0}


def tree_on_counts(steps: int, gated_crf: int = None) -> dict:
    """The counts of ``steps`` tree-on steps: per step one MST and one rooting
    launch for the four trees, four filter forwards and four backwards, and
    no run of the plain route's filter; one gated-CRF launch a step unless
    ``gated_crf`` says otherwise."""
    return {**ZERO_COUNTS, "gated_crf": steps if gated_crf is None else gated_crf,
            "tree_mst": steps, "tree_root": steps, "tree_fwd": 4 * steps, "tree_bwd": 4 * steps}


def federated_round_flags(img: int = IMG, batch: int = BATCH) -> list:
    """The flags of FedICRA "ours" rounds of 5 full-width ODOC clients x 2
    steps (1 head, 1 body) with evaluation every round, 2 rounds in all,
    which both the train CLI and the runner take: ``phase_cli``'s route 1
    (which stops after the first) and ``phase_distributed`` (both)."""
    return ["--img_class", "odoc", "--strategy", "FedICRA", "--procedure", "ours",
            "--model", "unet_lc_multihead", "--img_size", str(img), "--batch_size", str(batch),
            "--iters", "2", "--rep_iters", "1", "--eval_iters", "2", "--max_iterations", "4"]


def phase_cli(dev, fed_snapshot: str, img: int = IMG, batch: int = BATCH,
              faz_img: int = 256) -> dict:
    """The CLIs as a user runs them, in-process in a temporary directory.

    ``fed_snapshot`` is ``phase_federation``'s snapshot directory, which the
    test CLI's route reads. Each route runs with the launch counters set to 0 just before it and
    read just after, timed by the port's StepTimer (card synchronised); what
    the CLIs print is captured, and their last line is checked to be the
    JSON they return. Returns route 1's result."""
    from fedicra_torch.cli import runner as runner_cli
    from fedicra_torch.cli import test as test_cli
    from fedicra_torch.cli import train as train_cli
    from fedicra_torch.data import make_synthetic_split
    from fedicra_torch.models import net_factory
    from fedicra_torch.utils.profiling import StepTimer, annotate, trace

    timer = StepTimer()
    zero = ZERO_COUNTS

    def route(name, fn):
        """(result, printed lines, kernel counts, seconds, peak GiB) of one route."""
        _reset_kernel_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        with contextlib.redirect_stdout(out), timer.time(name, block_on=dev):
            result = fn()
        seconds = timer.summary()[name]["total_s"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = _kernel_counts()
        log(f"[cli] {name}: {seconds:.3f} s; max_memory_allocated {peak:.3f} GiB; "
            f"kernel launches {counts}")
        return result, out.getvalue().splitlines(), counts, seconds

    def printed_json(lines, result, name):
        if not lines or json.loads(lines[-1]) != json.loads(json.dumps(result)):
            raise AssertionError(f"{name}: last printed line is not the returned JSON")

    def finite_losses(final: dict, name: str, clients: int):
        losses = [final[f"client_{c}_total_loss"] for c in range(clients)]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        log(f"[cli] {name}: total_loss per client {[round(v, 6) for v in losses]}")

    with tempfile.TemporaryDirectory(prefix="fedicra_cli_") as tmp:
        # 1. the federated train CLI: 1 round of 5 full-width clients, 2 steps
        #    each, on the synthetic splits' default 24 images a client (those
        #    the runner's routes train on, [distributed] among them)
        snap_root = os.path.join(tmp, "model")
        fed_argv = ["--synthetic", "--snapshot_root", snap_root, "--exp", "fed",
                    *federated_round_flags(img, batch), "--stop_after", "2"]
        result, lines, counts, seconds = route("cli.train federated", lambda: train_cli.main(fed_argv))
        fed_result = {**result, "seconds": seconds}
        printed_json(lines, result, "cli.train federated")
        steps = 5 * 2
        log(f"[cli] cli.train federated: {seconds / steps:.3f} s per local step (wall / {steps}, "
            f"data, evaluation and checkpoints included); best_dice {result['best_dice']:.6f}")
        finite_losses(result["final"], "cli.train federated", 5)
        want = tree_on_counts(steps)
        if counts != want:
            raise AssertionError(f"cli.train federated: launches {counts}, expected {want}")
        # best_global is written when the weighted val dice beats 0 (the
        # reference's rule); after 1 round from random weights it may not
        wrote = os.path.exists(os.path.join(snap_root, "fed", "best_global"))
        if wrote != (result["best_dice"] > 0):
            raise AssertionError(f"best_global written {wrote}, best_dice {result['best_dice']}")

        # 2. the test CLI's route on the federation phase's snapshot (2 rounds
        #    with ALA, where some clients beat dice 0 and wrote their own
        #    best); the card has no h5py, so the cases are client 0's
        #    synthetic val split, as that run made it
        snap = fed_snapshot
        split = make_synthetic_split(4, img, img, 3, 3, seed=100, sparse=False)
        model = net_factory("unet_lc_multihead", in_chns=3, class_num=3, num_clients=5).to(dev)
        out_dir = os.path.join(snap_root, "fed_test", "client0")
        expect = "best_client_0" if os.path.exists(os.path.join(snap, "best_client_0")) else "best_global"

        def test_route():
            payload, source = test_cli.load_test_weights(snap, "client0", dev)
            rows = test_cli.run_inference(
                model, payload["params"], payload["batch_stats"], split.images, split.case_names,
                split.labels, "odoc", out_dir, emb_idx=0, device=dev)
            test_cli.write_csvs(rows, out_dir)
            return source, rows

        (source, rows), _, counts, seconds = route("cli.test inference", test_route)
        log(f"[cli] cli.test inference: loaded {source}; {seconds / len(split) * 1e3:.3f} ms per "
            f"inferred case ({len(split)} cases, metrics and PNGs included); mean dice_cup "
            f"{np.mean(rows['dice_cup']):.6f} dice_disc {np.mean(rows['dice_disc']):.6f}")
        if source != expect:
            raise AssertionError(f"loaded {source}, expected {expect} by the own-best rule")
        metrics = [f"{m}{g}" for g in ("_cup", "_disc")
                   for m in ("dice", "jaccard", "HD95", "ASSD", "SE", "SP", "Rec", "Pre")]
        if list(rows) != ["name"] + metrics or any(len(v) != len(split) for v in rows.values()):
            raise AssertionError(f"test CLI columns {list(rows)}")
        if not all(math.isfinite(v) for k in metrics for v in rows[k]):
            raise AssertionError("non-finite test metrics")
        if counts != zero:
            raise AssertionError(f"cli.test launched custom kernels: {counts}")
        with open(os.path.join(out_dir, "result.csv")) as f:
            if f.readline().strip().split(",") != list(rows):
                raise AssertionError("result.csv header")
        pngs = sorted(os.listdir(os.path.join(out_dir, "pre")))
        if len(pngs) != 2 * len(split) or not os.path.exists(os.path.join(out_dir, "mean_std_result.csv")):
            raise AssertionError(f"test CLI outputs {pngs}")
        for name in pngs:
            with open(os.path.join(out_dir, "pre", name), "rb") as f:
                head = f.read(24)
            if head[:8] != test_cli.PNG_SIGNATURE or head[12:16] != b"IHDR" or \
                    struct.unpack(">II", head[16:24]) != (img, img):
                raise AssertionError(f"{name} is not a {img}x{img} PNG")

        # 3. the centralized unet baseline at 256^2, then again inside a trace
        cen_argv = ["--centralized", "--synthetic", "--img_class", "faz", "--model", "unet",
                    "--max_iterations", "4", "--eval_iters", "2", "--limit_per_client", "24",
                    "--img_size", str(faz_img), "--batch_size", str(batch),
                    "--snapshot_root", snap_root, "--exp", "central"]
        trace_dir = os.path.join(tmp, "trace")

        def traced():
            with trace(trace_dir), annotate("cli.centralized"):
                return train_cli.main(cen_argv)

        for name, fn in (("cli.train centralized", lambda: train_cli.main(cen_argv)),
                         ("cli.train centralized traced", traced)):
            rec, lines, counts, seconds = route(name, fn)
            printed_json(lines, rec, name)
            log(f"[cli] {name}: {seconds / 4:.3f} s per step (wall / 4, 2 evaluations included); "
                f"loss {rec['loss']:.6f} mean_dice {rec['mean_dice']:.6f}")
            if rec["iter"] != 4 or not math.isfinite(rec["loss"]):
                raise AssertionError(f"{name}: record {rec}")
            if counts != zero:
                raise AssertionError(f"{name} launched custom kernels: {counts}")
        traces = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir)]
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        log(f"[cli] trace {os.path.basename(traces[0])}: {len(events)} events, {kernels} kernels")
        if len(traces) != 1 or not any(e.get("name") == "cli.centralized" for e in events):
            raise AssertionError("the trace lacks the cli.centralized span")

        # 4. the runner at its own defaults (FAZ, unet, FedAvg, pCE, 256^2,
        #    batch 12), from a working directory whose ../model and ../data
        #    lie inside the temporary directory
        sizes = [] if (faz_img, batch) == (256, 12) else [
            "--img_size", str(faz_img), "--batch_size", str(batch)]
        run_dir = os.path.join(tmp, "run")
        os.makedirs(run_dir)
        cwd = os.getcwd()
        os.chdir(run_dir)
        try:
            result, lines, counts, seconds = route("cli.runner", lambda: runner_cli.main(
                ["--procedure", "flower_pCE_2D", "--exp", "smoke", "--synthetic",
                 "--max_iterations", "2", "--iters", "2"] + sizes))
        finally:
            os.chdir(cwd)
        printed_json(lines, result, "cli.runner")
        log(f"[cli] cli.runner: {seconds / steps:.3f} s per local step (wall / {steps}, data "
            "included)")
        finite_losses(result["final"], "cli.runner", 5)
        if counts != zero:
            raise AssertionError(f"cli.runner launched custom kernels: {counts}")
        if not os.path.exists(os.path.join(tmp, "model", "smoke", "metrics.jsonl")):
            raise AssertionError("the runner wrote no ../model/smoke/metrics.jsonl")
    log("[cli] " + "; ".join(f"{k} {v['total_s']:.3f} s" for k, v in timer.summary().items()))
    return fed_result


def phase_models(dev, img: int = IMG, batch: int = BATCH) -> None:
    """``pnet`` and ``efficient_unet`` through the federated train CLI under
    ``--amp 1``: FedAvg, pCE, ODOC at full size, 1 round of 5 clients x 2
    steps, evaluation at iteration 2, each route timed by StepTimer (card
    synchronised) with the launch counters set to 0 just before it.
    ``efficient_unet`` loads a synthetic efficientnet-pytorch B3 file
    (``tests/torch_efficientnet_mirror.py``) as ``--encoder_weights``."""
    import torch.nn.modules.module as module_hooks

    import fedicra_torch.federation.experiment as experiment
    from fedicra_torch.cli import train as train_cli
    from fedicra_torch.models.efficientunet import EffiUNet, convert_torch_encoder_state_dict
    from fedicra_torch.models.pnet import PNet2D
    from fedicra_torch.utils.profiling import StepTimer

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_efficientnet_mirror import make_b3_state_dict

    timer = StepTimer()
    zero = ZERO_COUNTS
    steps = 5 * 2
    with tempfile.TemporaryDirectory(prefix="fedicra_models_") as tmp:
        weights = os.path.join(tmp, "efficientnet-b3.pth")
        b3 = make_b3_state_dict(in_chns=3, seed=0)
        torch.save(b3, weights)
        for model_type, cls, extra in (("pnet", PNet2D, []),
                                       ("efficient_unet", EffiUNet, ["--encoder_weights", weights])):
            name = f"cli.train {model_type} --amp 1"
            argv = ["--synthetic", "--img_class", "odoc", "--strategy", "FedAvg", "--procedure", "pce",
                    "--model", model_type, "--amp", "1", "--img_size", str(img),
                    "--batch_size", str(batch), "--iters", "2", "--eval_iters", "2",
                    "--stop_after", "2", "--limit_per_client", "12",
                    "--snapshot_root", os.path.join(tmp, "model"), "--exp", model_type,
                    "--device", str(dev)] + extra
            logits = set()

            def hook(module, args, out, cls=cls):
                if isinstance(module, cls) and module.training:
                    logits.add(str(out["logits"].dtype).replace("torch.", ""))

            states = []
            init = experiment.init_client_state

            def recording_init(*args, **kwargs):
                states.append(init(*args, **kwargs))
                return states[-1]

            handle = module_hooks.register_module_forward_hook(hook)
            experiment.init_client_state = recording_init
            _reset_kernel_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out), timer.time(name, block_on=dev):
                    result = train_cli.main(argv)
            finally:
                handle.remove()
                experiment.init_client_state = init
            seconds = timer.summary()[name]["total_s"]
            peak = torch.cuda.max_memory_allocated() / 2**30
            counts = _kernel_counts()
            losses = [result["final"][f"client_{c}_total_loss"] for c in range(5)]
            log(f"[models] {name}: {seconds:.3f} s; {seconds / steps:.3f} s per local step (wall / "
                f"{steps}, data, evaluation and checkpoints included); max_memory_allocated "
                f"{peak:.3f} GiB; kernel launches {counts}; training logits {sorted(logits)}; "
                f"total_loss per client {[round(v, 6) for v in losses]}; val_mean_dice "
                f"{result['final']['val_mean_dice']:.6f}")
            if json.loads(out.getvalue().splitlines()[-1]) != json.loads(json.dumps(result)):
                raise AssertionError(f"{name}: last printed line is not the returned JSON")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{name}: non-finite losses {losses}")
            if counts != zero:
                raise AssertionError(f"{name} launched custom kernels: {counts}")
            # JAX's AMP reaches pnet's bare convs nowhere; efficient_unet's
            # classifier computes in bf16
            want = {"float32"} if model_type == "pnet" else {"bfloat16"}
            if logits != want:
                raise AssertionError(f"{name}: training logits {logits}, expected {want}")
            if model_type == "efficient_unet":
                file_leaves = convert_torch_encoder_state_dict(b3)
                state = states[0]
                loaded = {**state.params, **state.batch_stats}
                for k, v in file_leaves.items():
                    if not torch.equal(loaded[f"encoder.{k}"].cpu(), v):
                        raise AssertionError(f"{name}: encoder leaf {k} is not the file's")
                log(f"[models] {name}: {len(file_leaves)} encoder leaves equal the file's")
    log("[models] " + "; ".join(f"{k} {v['total_s']:.3f} s" for k, v in timer.summary().items()))


def empty_cache_cost(dev, reps: int = 3):
    """What ``serve_client``'s ``torch.cuda.empty_cache()`` after each reply
    costs a client: a 2-step local round of the distributed phase's
    configuration (``main_path_setup``) after a warm round with the cache
    kept, against the same round right after ``empty_cache()``, in turns.
    Returns (kept s, emptied s, empty_cache s) per turn."""
    cfg, cid, model, state, round_fn, batches = main_path_setup(dev, iters=2, rep_iters=1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed(lambda: round_fn(state, batches, cid))  # warm-up
    kept, emptied, frees = [], [], []
    for _ in range(reps):
        kept.append(timed(lambda: round_fn(state, batches, cid)))
        frees.append(timed(torch.cuda.empty_cache))
        emptied.append(timed(lambda: round_fn(state, batches, cid)))
    del model, state, round_fn, batches
    torch.cuda.empty_cache()
    return kept, emptied, frees


def phase_distributed(dev, route1: dict, img: int = IMG, batch: int = BATCH,
                      timeout_s: float = 600.0) -> None:
    """The runner's ``--distributed`` route as a user starts it, from a
    temporary working directory: 1 server and 5 client processes on the
    card, over TCP, for 2 rounds whose first is ``phase_cli`` route 1's.
    Every process must exit 0 (the runner raises otherwise), each client's
    first-round fit loss must lie within rtol 1e-3 of route 1's, and every
    metric must be finite (hd95 aside, NaN where a mask is empty, as in
    JAX). Prints each round's wall time and each process's peak memory, as
    the processes report them; the children's kernel launches cannot be
    counted from here (their CUDA tensors have no route but the kernel).
    First, ``empty_cache_cost``: what the clients' empty_cache after each
    reply costs a round."""
    kept, emptied, frees = empty_cache_cost(dev)
    log(f"[distributed] a client's 2-step round with its cache kept {[round(x, 4) for x in kept]} s, "
        f"right after empty_cache {[round(x, 4) for x in emptied]} s; empty_cache itself "
        f"{[round(1e3 * x, 3) for x in frees]} ms (in turns)")
    torch.cuda.empty_cache()  # the card's memory, for the six processes
    from fedicra_torch.parallel.launch import free_port

    with tempfile.TemporaryDirectory(prefix="fedicra_dist_") as tmp:
        run_dir = os.path.join(tmp, "run")
        os.makedirs(run_dir)
        cmd = [sys.executable, "-m", "fedicra_torch.cli.runner", "--exp", "dist",
               "--synthetic", "--distributed", "--port", str(free_port()), *federated_round_flags(img, batch)]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        log(f"[distributed] {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=run_dir, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=timeout_s)
        finally:
            if proc.poll() is None:  # stop the runner and every process it started
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall = time.perf_counter() - t0
        lines = out.splitlines()
        peaks = [line for line in lines if "peak memory" in line]
        for line in lines:
            if line.startswith(("[server]", "[client", "[round", "Traceback", "RuntimeError")):
                log(f"[distributed] {line}")
        if proc.returncode != 0:
            raise AssertionError(f"--distributed exited with code {proc.returncode}:\n" + "\n".join(lines[-40:]))
        if len(peaks) != 6:
            raise AssertionError(f"expected 6 processes to report their peak memory, got {peaks}")
        with open(os.path.join(tmp, "model", "dist", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    if [r["step"] for r in records] != [2, 2, 4, 4]:
        raise AssertionError(f"metrics.jsonl steps {[r['step'] for r in records]}, expected 2 rounds")
    fit = records[0]  # round 1's fit record
    gaps = []
    for c in range(5):
        got, want = fit[f"client_{c}_total_loss"], route1["final"][f"client_{c}_total_loss"]
        gaps.append(abs(got - want) / abs(want))
        log(f"[distributed] client {c}: total_loss {got:.9g}, in-process (cli route 1) {want:.9g}, "
            f"relative gap {gaps[-1]:.3g}")
    server = next(line for line in lines if line.startswith("[server] run"))
    log(f"[distributed] 1 server + 5 clients: command {wall:.3f} s (process start-up, data and "
        f"connection included); {server[len('[server] '):]} (a round: 5 fits and 5 evaluations); "
        f"the in-process round (cli route 1, its route's wall) took {route1['seconds']:.3f} s")
    if max(gaps) > 1e-3:
        raise AssertionError(f"distributed losses {max(gaps):.3g} from the in-process route's")
    nonfinite = sorted({k for r in records for k, v in r.items()
                        if isinstance(v, float) and not math.isfinite(v)})
    log(f"[distributed] {len(records)} records, {sum(len(r) for r in records)} values; "
        f"non-finite: {nonfinite}")
    if any("hd95" not in k for k in nonfinite):
        raise AssertionError(f"non-finite metrics besides hd95: {nonfinite}")


def phase_lattice(dev) -> None:
    """``dense_crf_loss_lattice`` at the dense-CRF shape (12 x 384^2 inputs,
    N = 192^2, d = 5, C = 3) against the exact loss and gradient from the
    Gaussian-filter kernel on the lattice's own downscaled inputs: ratio in
    0.3-1.7, gradients' cosine above 0.9 (fedicra_tpu's bounds,
    tests/test_permutohedral.py). The lattice runs on the host (one thread
    an image); its time is the host clock's, transfers included."""
    from fedicra_torch.losses.dense_crf import dense_crf_loss, dense_crf_loss_lattice, resize_nearest_floor
    from fedicra_torch.losses.tree_energy import resize_linear
    from fedicra_torch.ops import gaussian_filter_cuda as gf
    from fedicra_torch.ops.permutohedral import permutohedral_filter

    images, logits, rois, _, _, _ = gaussian_filter_inputs(dev)
    probs = torch.softmax(logits, -1)
    b, h, w, c = probs.shape
    oh, ow = h // 2, w // 2
    t0 = time.perf_counter()
    approx, d_probs = dense_crf_loss_lattice(images, probs, rois)
    first_s = time.perf_counter() - t0  # the library's first use builds it
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        dense_crf_loss_lattice(images, probs, rois)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    # the exact loss and gradient on the same downscaled inputs (floor nearest)
    img_s = resize_nearest_floor(images * 255.0, (oh, ow))
    rois_s = resize_nearest_floor(rois[..., None], (oh, ow))
    s = (resize_linear(probs, (oh, ow)) * rois_s).reshape(b, oh * ow, c).contiguous()
    feats = gf.bilateral_features(img_s, 15.0, 50.0).contiguous()
    Ks = gf.gaussian_filter_cuda(feats, s)
    exact = (-2e-9 * (s.double() * Ks.double()).sum() / b).item()
    g_exact = ((-2.0 * 2e-9 / b) * rois_s.reshape(b, oh * ow, 1) * Ks).reshape(d_probs.shape)
    cos = (g_exact.double() * d_probs.double()).sum() / (g_exact.double().norm() * d_probs.double().norm())
    filter_s = []
    feats_host, s_host = feats.cpu(), s.cpu()
    for _ in range(3):
        t0 = time.perf_counter()
        permutohedral_filter(feats_host, s_host)
        filter_s.append(time.perf_counter() - t0)
    log(f"[lattice] B={b} N={oh * ow} d={feats.shape[2]} C={c}: loss lattice {approx:.9g}, exact "
        f"{exact:.9g} (ratio {approx / exact:.4f}); exact dense_crf_loss (nearest-exact inputs) "
        f"{dense_crf_loss(images, probs, rois).item():.9g}; gradient cosine {cos.item():.6f}")
    log(f"[lattice] dense_crf_loss_lattice {1e3 * statistics.median(times):.3f} ms per call "
        f"(runs {[round(1e3 * t, 3) for t in times]}; first call {1e3 * first_s:.3f} ms, g++ build "
        f"included); permutohedral_filter alone on host tensors "
        f"{1e3 * statistics.median(filter_s):.3f} ms; {os.cpu_count()} host cores")
    if not (approx < 0 and exact < 0 and 0.3 < approx / exact < 1.7):
        raise AssertionError(f"lattice loss {approx!r} vs exact {exact!r}")
    if not (cos > 0.9 and torch.isfinite(d_probs).all() and d_probs.device == probs.device):
        raise AssertionError(f"lattice gradient: cosine {cos.item()!r} to the exact one")


def phase_uncertainty(dev) -> None:
    """``batch_uncertainty`` of full-width ``unet_lc_multihead`` on 12 x 384^2
    ODOC images, T = 8, on the card: timed; the entropy in [-1e-5, ln 3];
    and on a 2-image slice with the same draws, equal to the CPU's at rtol
    1e-4."""
    from fedicra_torch.engine.config import TrainConfig
    from fedicra_torch.engine.trainer import init_client_state
    from fedicra_torch.evaluation.uncertainty import batch_uncertainty, draw_uncertainty
    from fedicra_torch.models import net_factory

    cfg = TrainConfig.for_task("odoc", model="unet_lc_multihead", img_size=IMG, batch_size=BATCH)
    model = net_factory("unet_lc_multihead", in_chns=3, class_num=3, num_clients=5)
    state = init_client_state(model, cfg, device=dev)
    images = torch.as_tensor(smooth_images(np.random.default_rng(6), BATCH, IMG, IMG), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = draw_uncertainty(images.shape, 8, gen)
    torch.cuda.reset_peak_memory_stats()
    value = batch_uncertainty(model, state.params, state.batch_stats, images, draws=draws).item()
    ms = cuda_median_ms(lambda: batch_uncertainty(model, state.params, state.batch_stats, images,
                                                  draws=draws), reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    small = draw_uncertainty(images[:2].shape, 8, gen)
    card = batch_uncertainty(model, state.params, state.batch_stats, images[:2], draws=small).item()
    model_cpu = net_factory("unet_lc_multihead", in_chns=3, class_num=3, num_clients=5)
    cpu = batch_uncertainty(model_cpu, {k: v.cpu() for k, v in state.params.items()},
                            {k: v.cpu() for k, v in state.batch_stats.items()}, images[:2].cpu(),
                            draws=(small[0], small[1].cpu())).item()
    log(f"[uncertainty] unet_lc_multihead B={BATCH} {IMG}^2 T=8, rotation {draws[0]}: entropy "
        f"{value:.9g}; {ms:.3f} ms per batch; max_memory_allocated {peak:.3f} GiB; 2-image slice "
        f"(rotation {small[0]}) card {card:.9g} cpu {cpu:.9g}")
    if not -1e-5 <= value <= math.log(3):
        raise AssertionError(f"entropy {value!r} outside [-1e-5, ln 3]")
    if not math.isclose(card, cpu, rel_tol=1e-4):
        raise AssertionError(f"uncertainty: card {card!r} vs cpu {cpu!r}")


def phase_gated_crf_surface(dev) -> None:
    """The full gated-CRF surface (plain PyTorch) at 12 x 384^2, radius 5:
    the Potts kernel with an all-ones ``mask_dst`` against the CUDA kernel's
    loss (rtol 1e-5); masked, compatibility and two-kernel runs on the card
    against the CPU on one image (rtol 1e-5); forward and backward timed,
    peak memory under 8 GiB."""
    from fedicra_torch.losses.gated_crf import LIVE_KERNEL, gated_crf_loss, gated_crf_loss_auto

    b, c, r = BATCH, 3, 5
    rng = np.random.default_rng(7)
    image = torch.as_tensor(smooth_images(rng, b, IMG, IMG), device=dev)
    logits = torch.as_tensor(rng.normal(size=(b, IMG, IMG, c)).astype(np.float32), device=dev)
    probs = torch.softmax(logits, -1)
    mask = rng.choice([1.0, 1.0, 1.0, 0.0, 0.5], size=(b, IMG, IMG)).astype(np.float32)
    mask[0, :4, :4] = np.nan
    mask = torch.as_tensor(mask, device=dev)
    ones = torch.ones((b, IMG, IMG), device=dev)

    kernel = gated_crf_loss_auto(probs, image, radius=r).item()
    general = gated_crf_loss(probs, image, radius=r, kernels_desc=[LIVE_KERNEL], mask_dst=ones).item()
    log(f"[gated-crf-surface] Potts, all-ones mask_dst: general path {general:.9g}, CUDA kernel "
        f"{kernel:.9g} (relative gap {abs(general - kernel) / abs(kernel):.3g})")
    if not math.isclose(general, kernel, rel_tol=1e-5):
        raise AssertionError(f"general path {general!r} vs kernel {kernel!r}")

    runs = {
        "masked": dict(mask_src=mask, mask_dst=mask.flip(1)),
        "compatibility": dict(compatibility=torch.tensor([[0.0, 1.0, 3.0], [2.0, 0.0, 0.5],
                                                          [1.0, 1.0, 0.0]])),
        "two kernels": dict(kernels_desc=[{"weight": 0.7, "xy": 4.0, "rgb": 0.2},
                                          {"weight": 0.3, "xy": 2.0}]),
    }
    for name, kw in runs.items():
        one = {k: (v[:1] if k.startswith("mask") else v) for k, v in kw.items()}
        on_card = gated_crf_loss(probs[:1], image[:1], radius=r, **one).item()
        on_cpu = gated_crf_loss(probs[:1].cpu(), image[:1].cpu(), radius=r,
                                **{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in one.items()}).item()
        log(f"[gated-crf-surface] {name}, image 0: card {on_card:.9g} cpu {on_cpu:.9g}")
        if not math.isclose(on_card, on_cpu, rel_tol=1e-5):
            raise AssertionError(f"{name}: card {on_card!r} vs cpu {on_cpu!r}")

    full = dict(kernels_desc=runs["two kernels"]["kernels_desc"], mask_src=mask, mask_dst=mask.flip(1),
                compatibility=runs["compatibility"]["compatibility"])
    for name, kw in (("Potts, all-ones mask_dst", dict(kernels_desc=[LIVE_KERNEL], mask_dst=ones)),
                     ("two kernels, both masks, compatibility", full)):
        lg = logits.clone().requires_grad_(True)
        fwd, bwd = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(4):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
            loss = gated_crf_loss(torch.softmax(lg, -1), image, radius=r, **kw)
            events[1].record()
            loss.backward()
            events[2].record()
            events[2].synchronize()
            fwd.append(events[0].elapsed_time(events[1]))
            bwd.append(events[1].elapsed_time(events[2]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[gated-crf-surface] {name} at B={b} {IMG}^2 r={r}: forward "
            f"{statistics.median(fwd[1:]):.3f} ms, backward {statistics.median(bwd[1:]):.3f} ms "
            f"(medians of 3 after a warm-up); max_memory_allocated {peak:.3f} GiB")
        if not (torch.isfinite(lg.grad).all() and lg.grad.abs().max() > 0):
            raise AssertionError(f"{name}: non-finite or zero gradient")
        if peak >= 8.0:
            raise AssertionError(f"{name}: peak memory {peak:.3f} GiB, not under 8")


def full_fp32() -> None:
    """No TF32 in cuDNN's convolutions or in matmuls: every phase, and every
    rank a phase spawns, computes in full fp32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def card_name_and_power() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from fedicra_torch import resolve_device

    dev = resolve_device()
    full_fp32()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"[env] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    phase_build()
    gated_row = phase_gated_crf(dev)
    torch.cuda.empty_cache()
    gaussian_row = phase_gaussian_filter(dev)
    phase_tree_plain(dev)
    tree_rows = phase_tree_kernels(dev)
    dsn_rows = phase_dsn_stats(dev)
    torch.cuda.empty_cache()
    phase_small_agreement(dev)
    phase_round(dev, "tree-off", tree_loss_weight=0.0, iters=2, rep_iters=1)
    torch.cuda.empty_cache()
    main_run = phase_round(dev, "main", treeenergy_add=True)
    for row in [gated_row, *tree_rows, dsn_rows[0]]:
        row["launches"] = main_run["launches"][row["name"]]
    rows = [gated_row, gaussian_row, *tree_rows, *dsn_rows]
    torch.cuda.empty_cache()
    phase_main_amp(dev, main_run)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="fedicra_smoke_") as tmp:
        fed_snapshot = os.path.join(tmp, "federation")
        fed_losses = phase_federation(dev, fed_snapshot)
        torch.cuda.empty_cache()
        federation_fedadam(dev, federation_config(IMG), 12)
        torch.cuda.empty_cache()
        phase_sharded(dev, fed_losses)
        torch.cuda.empty_cache()
        route1 = phase_cli(dev, fed_snapshot)
    torch.cuda.empty_cache()
    phase_models(dev)
    phase_distributed(dev, route1)
    torch.cuda.empty_cache()
    phase_lattice(dev)
    phase_uncertainty(dev)
    torch.cuda.empty_cache()
    phase_gated_crf_surface(dev)
    torch.cuda.empty_cache()
    rows += phase_tasks(dev)

    print(card_name_and_power())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
