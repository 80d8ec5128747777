#!/usr/bin/env python3
"""Drive the PyTorch port (fedicra_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. build every CUDA source under fedicra_torch/csrc for sm_90a (nvcc);
2. each kernel against its plain PyTorch twin at the main-path shape
   (gated CRF: B=12, C=3, 384x384, radius 5), with times and bounds;
3. the slice's objective on the card against the same objective on the CPU
   (plain gated CRF there) at a small input;
4. the main path: one FedICRA local round of the "ours" objective with the
   tree term off, full-width unet_lc_multihead for ODOC (384^2, batch 12,
   5 clients, real dropout rates), 2 head steps then 2 body steps, with the
   kernels' launch counters read around it.

The last lines are the card's name and power limit, one JSON line of
per-kernel numbers, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor-core) op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_build():
    from fedicra_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {len(_build.sources())} source(s) built in {time.perf_counter() - t0:.2f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def smooth_images(rng, b: int, h: int, w: int) -> np.ndarray:
    """(b, h, w, 3) images in [0, 1] that vary slowly, dark at the top-left.

    The gated CRF's guide is rgb/0.1, so on per-pixel noise nearly every
    neighbour weight k_o is ~0. Slow waves keep k_o spread over (0, 1), and
    the dark corner keeps the zero-padded border terms there from vanishing.
    """
    v = np.linspace(0.0, 1.0, h)[:, None, None]
    u = np.linspace(0.0, 1.0, w)[None, :, None]
    freq = rng.uniform(1.0, 3.0, size=(b, 1, 1, 3, 2))
    phase = rng.uniform(0.0, 2 * np.pi, size=(b, 1, 1, 3))
    wave = np.sin(2 * np.pi * (freq[..., 0] * u + freq[..., 1] * v) + phase)
    img = u * v * (0.6 + 0.3 * wave) + 0.005 * rng.normal(size=(b, h, w, 3))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def phase_gated_crf(dev):
    """Kernel vs plain twin at B=12, C=3, 384^2, r=5; returns the JSON rows."""
    from fedicra_torch.losses.gated_crf import gated_crf_features
    from fedicra_torch.ops import gated_crf_cuda as g

    b, c, h, w, r = 12, 3, 384, 384, 5
    rng = np.random.default_rng(0)
    logits = torch.as_tensor(rng.normal(size=(b, c, h, w)).astype(np.float32), device=dev)
    image = torch.as_tensor(smooth_images(rng, b, h, w), device=dev)
    y = torch.softmax(logits, dim=1).contiguous()
    f = gated_crf_features(image, 6.0, 0.1).permute(0, 3, 1, 2).contiguous()
    nf = f.shape[1]
    denom = b * h * w

    loss_k = g.gated_crf_fwd_cuda(y, f, r)
    loss_k2 = g.gated_crf_fwd_cuda(y, f, r)
    torch.cuda.synchronize()
    if not torch.equal(loss_k, loss_k2):
        raise AssertionError("gated_crf_fwd: two runs on the same input differ")
    y_ref = y.clone().requires_grad_(True)
    loss_p = g.gated_crf_potts_plain(y_ref, f, r)
    (grad_p,) = torch.autograd.grad(loss_p, y_ref, retain_graph=True)
    fwd_err = abs(loss_k.item() - loss_p.item())
    log(f"[gated_crf] loss kernel {loss_k.item():.9g} plain {loss_p.item():.9g} |diff| {fwd_err:.3g}")
    torch.testing.assert_close(loss_k, loss_p.detach(), rtol=1e-5, atol=0)

    # dL/dy = -2/(B H W) acc is ~1e-6 here, so an atol of 1e-6 on it would
    # pass nearly anything: hold the kernel's unscaled acc(q) to the twin's.
    acc_k = g.gated_crf_bwd_cuda(y, f, r)
    acc_p = grad_p * (-denom / 2.0)
    y_auto = y.clone().requires_grad_(True)
    g.gated_crf_potts(y_auto, f, r).backward()
    torch.cuda.synchronize()
    bwd_err = (acc_k - acc_p).abs().max().item()
    # sum_c acc(q) = sum of k_o(q) over q's neighbours inside the image
    mean_k = acc_p.sum(dim=1).mean().item() / ((2 * r + 1) ** 2 - 1)
    log(f"[gated_crf] acc max |kernel - plain| {bwd_err:.3g} (max acc {acc_p.abs().max().item():.4g}, "
        f"mean k over pairs {mean_k:.4g})")
    torch.testing.assert_close(acc_k, acc_p, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(y_auto.grad * (-denom / 2.0), acc_p, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(acc_k * (-2.0 / denom), grad_p, rtol=1e-4, atol=1e-6)

    fwd_ms = cuda_median_ms(lambda: g.gated_crf_fwd_cuda(y, f, r))
    bwd_ms = cuda_median_ms(lambda: g.gated_crf_bwd_cuda(y, f, r))
    with torch.no_grad():
        plain_fwd_ms = cuda_median_ms(lambda: g.gated_crf_potts_plain(y, f, r), reps=10)
    plain_bwd_ms = cuda_median_ms(
        lambda: torch.autograd.grad(loss_p, y_ref, retain_graph=True), reps=10
    )

    # Work of one call: (pixel, offset) pairs, each with 3F + 2C + 5
    # (forward) or 3F + 2C + 2 (backward) fp32 operations, one of them an
    # exp and each FMA counted as two.
    pairs = b * h * w * ((2 * r + 1) ** 2 - 1)
    in_bytes = 4 * (y.numel() + f.numel())

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / FP32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    fwd_bound, fwd_by = bound(pairs * (3 * nf + 2 * c + 5), in_bytes + 4)
    bwd_bound, bwd_by = bound(pairs * (3 * nf + 2 * c + 2), in_bytes + 4 * y.numel())
    log(f"[gated_crf] fwd kernel {fwd_ms:.4f} ms plain {plain_fwd_ms:.4f} ms bound {fwd_bound:.4f} ms ({fwd_by})")
    log(f"[gated_crf] bwd kernel {bwd_ms:.4f} ms plain {plain_bwd_ms:.4f} ms bound {bwd_bound:.4f} ms ({bwd_by})")
    log("[gated_crf] library_ms: none -- no single PyTorch call computes this function")
    common = dict(route="cuda", source="fedicra_torch/csrc/gated_crf.cu", library_ms=None)
    return [
        dict(name="gated_crf_fwd", replaces="fedicra_tpu/ops/gated_crf_pallas.py:77",
             max_abs_err=fwd_err, ms=fwd_ms, plain_ms=plain_fwd_ms,
             bound_ms=fwd_bound, bound_by=fwd_by, **common),
        dict(name="gated_crf_bwd", replaces="fedicra_tpu/ops/gated_crf_pallas.py:106",
             max_abs_err=bwd_err, ms=bwd_ms, plain_ms=plain_bwd_ms,
             bound_ms=bwd_bound, bound_by=bwd_by, **common),
    ]


def phase_small_agreement(dev):
    """The objective on the card (CUDA kernel) against the CPU (plain twin)."""
    from fedicra_torch.engine.config import TrainConfig
    from fedicra_torch.engine.objective import ours_loss
    from fedicra_torch.engine.trainer import init_client_state
    from fedicra_torch.models import net_factory

    cfg = TrainConfig.for_task("odoc", img_size=32, batch_size=2, tree_loss_weight=0.0)
    rng = np.random.default_rng(2)
    image = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    label = np.where(rng.uniform(size=(2, 32, 32)) < 0.7, 3, rng.integers(0, 3, (2, 32, 32)))
    results = {}
    for device in ("cpu", dev):
        model = net_factory("unet_lc_multihead", in_chns=3, class_num=3,
                            dropout=(0.0,) * 5, dsn_dropout=0.0)
        init_client_state(model, cfg, seed=5, device=device)
        model.train()
        batch = {"image": torch.as_tensor(image, device=device),
                 "label": torch.as_tensor(label, device=device)}
        loss, metrics = ours_loss(model, batch, 1, cfg)
        loss.backward()
        results[str(device)] = (
            {k: v.item() for k, v in metrics.items() if v.ndim == 0},
            model.decoder.out_conv.weight.grad.cpu(),
        )
    (m_cpu, g_cpu), (m_gpu, g_gpu) = results["cpu"], results[str(dev)]
    for k in m_cpu:
        if not math.isclose(m_cpu[k], m_gpu[k], rel_tol=1e-4, abs_tol=1e-6):
            raise AssertionError(f"{k}: card {m_gpu[k]!r} vs cpu {m_cpu[k]!r}")
    torch.testing.assert_close(g_gpu, g_cpu, rtol=1e-3, atol=1e-6)
    log(f"[small] ours_loss card {m_gpu['total_loss']:.7g} cpu {m_cpu['total_loss']:.7g}; "
        f"out_conv grad max |diff| {(g_gpu - g_cpu).abs().max().item():.3g}")


def main_path_setup(dev):
    """The main path's workload: ODOC at full width, 4 steps (2 head, 2 body).

    Returns (cfg, cid, model, state, round_fn, batches); random weights from
    cfg.seed, smooth images and 95%-unlabelled scribbles from numpy seed 1.
    """
    from fedicra_torch.engine.config import TrainConfig
    from fedicra_torch.engine.trainer import init_client_state, make_round_fn
    from fedicra_torch.models import net_factory

    cfg = TrainConfig.for_task(
        "odoc", procedure="ours", strategy="FedICRA", model="unet_lc_multihead",
        tree_loss_weight=0.0, iters=4, rep_iters=2, batch_size=12,
    )
    cid = 1
    model = net_factory("unet_lc_multihead", in_chns=cfg.in_chns, class_num=cfg.num_classes,
                        num_clients=cfg.num_clients, client_id=cid)
    state = init_client_state(model, cfg, seed=cfg.seed, device=dev)
    round_fn = make_round_fn(model, cfg, device=dev)

    rng = np.random.default_rng(1)
    shape = (cfg.iters, cfg.batch_size, cfg.img_size, cfg.img_size)
    images = smooth_images(rng, cfg.iters * cfg.batch_size, cfg.img_size, cfg.img_size)
    images = images.reshape(shape + (cfg.in_chns,))
    labels = rng.integers(0, cfg.num_classes, size=shape)
    labels = np.where(rng.uniform(size=shape) < 0.95, cfg.num_classes, labels)
    batches = {"image": torch.as_tensor(images, device=dev),
               "label": torch.as_tensor(labels, device=dev)}
    return cfg, cid, model, state, round_fn, batches


def phase_main_path(dev):
    """One FedICRA round at full width; returns the kernels' launch counts."""
    from fedicra_torch.models.params_filters import is_dsn_head, is_head, is_pcs
    from fedicra_torch.ops import gated_crf_cuda

    cfg, cid, model, state, round_fn, batches = main_path_setup(dev)
    iters, rep = cfg.iters, cfg.rep_iters
    n_params = sum(p.numel() for p in state.params.values())
    log(f"[main] unet_lc_multihead {n_params} params; batches {tuple(batches['image'].shape)}; cid {cid}")

    snaps, stamps = [], []

    def on_step(j, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if j == iters - rep - 1:
            snaps.append({n: p.detach().clone() for n, p in model.named_parameters()})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gated_crf_cuda.reset_launches()
    t0 = time.perf_counter()
    new, metrics = round_fn(state, batches, cid, on_step=on_step)
    torch.cuda.synchronize()
    launches = dict(gated_crf_cuda.launches)

    losses = metrics["total_loss"].cpu()
    steps = np.diff([t0] + stamps) * 1e3
    log(f"[main] total_loss per step {losses.tolist()}")
    for k in ("loss_ce", "loss_crf", "loss_lc"):
        log(f"[main] {k} per step {metrics[k].cpu().tolist()}")
    log(f"[main] step ms {[round(float(s), 3) for s in steps]}")
    log(f"[main] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[main] kernel launches {launches}")

    if losses.shape != (iters,) or not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite or misshapen losses {losses}")
    for k in ("loss_ce", "loss_crf", "loss_lc"):
        if not torch.isfinite(metrics[k]).all():
            raise AssertionError(f"{k} not finite")
    if launches != {"gated_crf_fwd": iters, "gated_crf_bwd": iters}:
        raise AssertionError(f"expected one forward and one backward launch per step, got {launches}")
    before, after, head_end = state.params, new.params, snaps[0]
    for n in before:
        if (is_pcs(n) or is_dsn_head(n)) and not torch.equal(before[n], after[n]):
            raise AssertionError(f"frozen parameter {n} changed")
        moved = not torch.equal(before[n], head_end[n])
        if moved != is_head(n):
            raise AssertionError(f"head phase: {n} moved={moved}")
    if new.current_iter != iters:
        raise AssertionError(f"current_iter {new.current_iter}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from fedicra_torch import resolve_device

    dev = resolve_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"[env] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    phase_build()
    rows = phase_gated_crf(dev)
    torch.cuda.empty_cache()
    phase_small_agreement(dev)
    launches = phase_main_path(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
