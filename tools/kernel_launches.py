#!/usr/bin/env python3
"""Launch counts by kernel name in one traced local round of a benchmark cell.

    python3 tools/kernel_launches.py --workload odoc.local_rounds --seed 1 [--out FILE]

From the root of a checkout, on a machine with a CUDA card. It builds the
cell's program as ``benchmark/drivers/local_rounds.py`` does (the seed's
weights, states and pools), runs client 0's first round to warm every
shape, then profiles one round of the window's first client and prints one
JSON object: every convolution kernel (the names ``conv_ms.train`` reads)
with its launches, device ms and the streams it ran on; every convolution
op (forward and backward) by its input shapes, with its calls,
the kernels it launched and their device ms; and totals: all kernel
launches, the convolutions', those of cuDNN's FFT route (``fft`` and
``region_transform`` kernels, and the complex GEMMs ``cf32`` it runs its
products by) and the streams the convolutions used. ``--out`` also writes
the object to a file.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FFT_ROUTE = ("fft", "region_transform", "cf32")
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env

    env.prepare(ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.drivers.local_rounds import Program, cycle
    from benchmark.harness import readers, trace
    from benchmark.run import load_cell

    if not torch.cuda.is_available():
        raise SystemExit("kernel_launches: needs a CUDA card")
    cell = load_cell(args.workload)
    env.set_precision(cell["precision"])
    conv = readers.load("conv_ms.train")
    device = torch.device("cuda", 0)
    prog = Program(cell["config"], cell["precision"], cell["traffic"], args.seed, device)
    prog.checked_round()
    cid = cycle(cell["config"]["task"]["num_clients"])[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        prog.next_round(cid, lambda j, metrics: None)
        torch.cuda.synchronize()

    kernels = defaultdict(lambda: {"launches": 0, "ms": 0.0, "streams": set()})
    launches = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA or ev.is_user_annotation():
            continue
        name = ev.name()
        if "memcpy" in name.lower() or "memset" in name.lower():
            continue
        launches += 1
        if trace.matches(name, conv.INCLUDE, conv.EXCLUDE):
            k = kernels[name]
            k["launches"] += 1
            k["ms"] += (ev.end_ns() - ev.start_ns()) / 1e6
            k["streams"].add(ev.device_resource_id())
    ops = defaultdict(lambda: {"calls": 0, "launches": 0, "ms": 0.0, "kernels": defaultdict(float)})
    for ev in prof.events():
        if ev.name not in CONV_OPS:
            continue
        op = ops[json.dumps([ev.name, [list(s) for s in ev.input_shapes[:3]]])]
        op["calls"] += 1
        for k in ev.kernels:
            op["launches"] += 1
            op["ms"] += k.duration / 1e3
            op["kernels"][k.name[:90]] += k.duration / 1e3
    rows = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])
    streams = set().union(*(k["streams"] for k in kernels.values())) if kernels else set()
    result = {
        "workload": args.workload, "seed": args.seed, "client": cid,
        "device": torch.cuda.get_device_name(0), "steps": cell["config"]["train"]["iters"],
        "kernel_launches": launches,
        "conv_launches": sum(k["launches"] for k in kernels.values()),
        "conv_ms": sum(k["ms"] for k in kernels.values()),
        "fft_route_launches": sum(k["launches"] for n, k in kernels.items()
                                  if trace.matches(n, FFT_ROUTE)),
        "conv_streams": len(streams),
        "conv_kernels": [{"name": n, "launches": k["launches"], "ms": round(k["ms"], 4),
                          "streams": len(k["streams"])} for n, k in rows],
        "conv_ops": [{"op": json.loads(key), "calls": o["calls"], "launches": o["launches"],
                      "ms": round(o["ms"], 4),
                      "kernels": sorted(((round(ms, 3), n) for n, ms in o["kernels"].items()),
                                        reverse=True)[:4]}
                     for key, o in sorted(ops.items(), key=lambda kv: -kv[1]["ms"])],
    }
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
