#!/usr/bin/env python3
"""Where a step of the port's FedICRA round spends the card's time.

    python3 tools/profile_torch_round.py

Runs the main path of ``chip_smoke.py``, as ``chip_smoke.main_path_setup``
builds it (ODOC 384^2, batch 12, full-width unet_lc_multihead, "ours" at
the default tree_loss_weight=0.1, 2 head + 2 body steps; TF32 off): one
round to warm up, one round timed (step times, peak memory), then one round
under ``torch.profiler``. Prints the kernel time by kernel family and the
top kernels, and the device-busy share of the profiled round's wall time
(the union of device intervals: cuDNN may run kernels on more than one
stream). Then the same round at tree_loss_weight=0, warmed up and timed, so
that the tree term's share of the step is the difference. Ends with one
JSON summary line. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Kernel-name substrings per family, first match wins (batch norm before
# convolution: cuDNN's batch-norm kernels carry "cudnn" in their names).
FAMILIES = (
    ("gated_crf", ("gated_crf",)),  # gated_crf_fused_kernel
    # csrc/tree_filter.cu: MST (tiles, edges between them, the contracted
    # graph), BFS rooting (masks, the BFS, parents and weights), and the
    # filter's forward and backward (the parallel gathers and scatters, the
    # passes, d embed)
    ("tree_kernels", ("mst_tile_kernel", "mst_cross_kernel", "mst_contract_kernel",
                      "tree_mask_kernel", "tree_bfs_kernel", "root_weights_kernel",
                      "fwd_gather_kernel", "tree_pass_kernel", "fwd_scatter_kernel",
                      "bwd_gather_kernel", "bwd_scatter_kernel", "dembed_kernel")),
    ("sort", ("sort", "radix")),
    ("gather_scatter", ("gather", "scatter", "index")),
    ("batch_norm", ("batch_norm", "bn_", "batchnorm", "welford")),
    ("conv", ("conv", "xmma", "implicit", "gemm", "cudnn", "sm90", "cutlass", "winograd", "fft",
              "region_transform")),
    ("optimizer", ("adam", "multi_tensor", "foreach")),
    ("pool_resize", ("pool", "upsample", "interp")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "fill", "cat")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_round: needs a CUDA card", file=sys.stderr)
        return 2

    from chip_smoke import card_name_and_power, main_path_setup
    from fedicra_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")

    def timed_round(cid, state, round_fn, batches):
        stamps = []

        def on_step(j, metrics):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        round_fn(state, batches, cid, on_step=on_step)
        return np.diff([t0] + stamps) * 1e3

    cfg, cid, _, state, round_fn, batches = main_path_setup(dev)
    round_fn(state, batches, cid)  # warm-up: cuDNN heuristics, lazy init
    torch.cuda.reset_peak_memory_stats()
    steps = timed_round(cid, state, round_fn, batches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        round_fn(state, batches, cid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    _, cid0, _, state0, round_fn0, batches0 = main_path_setup(dev, tree_loss_weight=0.0)
    round_fn0(state0, batches0, cid0)  # warm-up
    steps_off = timed_round(cid0, state0, round_fn0, batches0)
    tree_share = 1 - steps_off.sum() / steps.sum()

    by_kernel = defaultdict(lambda: [0.0, 0])
    device_events = {
        (e.name, e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
    }
    spans = []
    for name, start, end in device_events:
        rec = by_kernel[name]
        rec[0] += (end - start) / 1e3
        rec[1] += 1
        spans.append((start, end))
    if not by_kernel:
        print("profile_torch_round: the profiler recorded no device events", file=sys.stderr)
        return 1
    kernel_ms = sum(v[0] for v in by_kernel.values())
    # busy = the union of device intervals (kernels on several streams overlap)
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_ms = (busy_us + cur_end - cur_start) / 1e3
    fams = defaultdict(float)
    for name, (ms, _) in by_kernel.items():
        fams[family(name)] += ms

    print(f"card: {torch.cuda.get_device_name(0)} ({card_name_and_power()})")
    print(f"round of {cfg.iters} steps ({cfg.iters - cfg.rep_iters} head, {cfg.rep_iters} body) at "
          f"tree_loss_weight {cfg.tree_loss_weight}: step ms {[round(float(s), 3) for s in steps]}, "
          f"peak memory {peak_gib:.3f} GiB; profiled round wall {wall_ms:.3f} ms")
    print(f"the same round at tree_loss_weight 0: step ms {[round(float(s), 3) for s in steps_off]}; "
          f"tree term's share of the step time {100 * tree_share:.2f}%")
    print(f"device busy (union of device intervals) {busy_ms:.3f} ms = "
          f"{100 * busy_ms / wall_ms:.2f}% of wall; idle {100 * (1 - busy_ms / wall_ms):.2f}%; "
          f"kernel time summed over streams {kernel_ms:.3f} ms")
    print("kernel time by family (ms, share of summed kernel time):")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:12s} {ms:10.3f}  {100 * ms / kernel_ms:6.2f}%")
    print("tree kernels (ms, launches):")
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0]):
        if family(name) == "tree_kernels":
            print(f"  {ms:10.3f} {n:6d}  {name[:110]}")
    print("top kernels (ms, launches):")
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {ms:10.3f} {n:6d}  {name[:110]}")
    print(json.dumps({
        "wall_ms": wall_ms, "step_ms": [float(s) for s in steps], "busy_ms": busy_ms,
        "peak_gib": peak_gib, "step_ms_tree_off": [float(s) for s in steps_off],
        "tree_share": tree_share,
        "kernel_ms": kernel_ms,
        "idle_share": 1 - busy_ms / wall_ms, "family_ms": dict(fams),
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
