"""Batch moments of a 3x3 convolution's output from its input: the CUDA
kernels of ``csrc/dsn_stats.cu`` and their plain twin.

A deep-supervision head's statistics-only forward (``models/blocks.py``
``DSNHead.advance_stats``) needs the batch mean and biased variance of its
3x3 conv's 512-channel output, over B x H x W, and not the output itself.
With p the zero-padded 3x3 patch at a pixel (K = 9 C entries, in the conv
weight's (C, 3, 3) order), M pixels, mu the patch mean and G the centred
patch Gram matrix, output channel o (weights w_o, bias b_o) has::

    mean_o = w_o . mu + b_o          var_o = w_o^T G w_o / M

Both routes shift the input by its channel means m (rounded to fp32), form
the Gram G_m of the shifted patches and correct it exactly:
G = G_m - M d d^T with d = mu - m, so var_o = w_o^T G_m w_o / M - (w_o . d)^2,
in float64. The kernels (route: CUDA C++ for sm_90a, built by ``ops/_build.py``
and bound with ctypes; four launches a call) accumulate G_m in fp32 by bands
of rows and sum the bands in float64; the plain twin forms it in float64 by
``F.unfold`` and a matrix product. Neither forms the conv's output.

``conv3x3_batch_moments`` takes the twin for CPU tensors and the kernels for
CUDA tensors (it raises on what they do not take; nothing falls back).
Under a data shard (``parallel/data_axis.py``) the tap sums and G_m are
summed over the group, as ``BatchNorm`` sums its moments. Given the running
buffers it advances them in place by BatchNorm's rule (momentum, biased
variance). The kernels' scratch is one buffer a device and stream, kept and
grown as needed. ``launches`` counts calls of the kernel route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.data_axis import current_shard
from ._build import load_library

TAPS = 9
GROUP = 16  # input channels in one of the kernel's channel groups
# a band of the gram kernel's holds at most this many pixels of one image
BAND_PIXELS = 8192

launches = {"dsn_stats": 0}

Running = Optional[Tuple[torch.Tensor, torch.Tensor]]


def reset_launches() -> None:
    launches["dsn_stats"] = 0


def conv3x3_batch_moments_plain(x: torch.Tensor, weight: torch.Tensor,
                                bias: Optional[torch.Tensor], running: Running = None,
                                momentum: float = 0.1):
    """The kernels' arithmetic in plain PyTorch: ``(mean, var)`` in float64,
    and the running buffers advanced when given. CPU tensors take it."""
    b, c, h, w = x.shape
    cols = F.unfold(x.float(), 3, padding=1)  # (B, 9C, HW)
    tap = cols.double().sum(dim=(0, 2))
    shard = current_shard()
    count = (b if shard is None else shard.batch) * h * w
    if shard is not None:
        tap = shard.sum(tap)
    shift = (tap.view(c, TAPS)[:, TAPS // 2] / count).float().repeat_interleave(TAPS)
    p = (cols - shift[None, :, None]).transpose(0, 1).reshape(c * TAPS, -1).double()
    G = p @ p.T
    if shard is not None:
        G = shard.sum(G)
    d = tap / count - shift.double()  # the patch mean less the shift
    wo = weight.reshape(weight.shape[0], -1).double()
    mean = wo @ (tap / count) + (0.0 if bias is None else bias.double())
    var = (((wo @ G) * wo).sum(dim=1) / count - (wo @ d) ** 2).clamp(min=0.0)
    if running is not None:
        with torch.no_grad():
            for buf, stat in zip(running, (mean, var)):
                buf.mul_(1.0 - momentum).add_(stat.to(buf.dtype), alpha=momentum)
    return mean, var


@functools.cache
def band_rows(h: int, w: int, blocks_per_band: int, concurrency: int) -> int:
    """Rows in each of the gram kernel's bands for an (h, w) image, where each
    band of each image takes ``blocks_per_band`` blocks and the card holds
    ``concurrency`` at once: a wave of blocks lasts as long as its tallest
    band, and each block costs about a row more (its set-up, its halo and
    its partial tiles), so the height that takes the fewest waves times
    rows + 1, the taller on a tie, at most ``BAND_PIXELS`` pixels a band
    (each thread sums its band in fp32) unless one row holds more."""
    top = min(h, max(1, BAND_PIXELS // w))

    def cost(rows: int) -> int:
        return math.ceil(blocks_per_band * math.ceil(h / rows) / concurrency) * (rows + 1)

    return min(range(1, top + 1), key=lambda rows: (cost(rows), -rows))


def _check(x, weight, bias, running) -> None:
    per_channel = {"bias": bias}
    if running is not None:
        per_channel.update({"running mean": running[0], "running var": running[1]})
    named = {"x": x, "weight": weight, **{k: v for k, v in per_channel.items() if v is not None}}
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on x's device, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim != 4 or weight.shape != (weight.shape[0], x.shape[1], 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not a 3x3 conv of x {tuple(x.shape)}")
    for name, t in named.items():
        if name in per_channel and t.shape != weight.shape[:1]:
            raise ValueError(f"{name} {tuple(t.shape)} does not match {weight.shape[0]} output channels")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("dsn_stats")
    p, i, d, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_float
    lib.dsn_gram_threads.argtypes = [i]
    lib.dsn_gram_threads.restype = i
    lib.dsn_prepare.argtypes = [i, ctypes.POINTER(i)]
    lib.dsn_prepare.restype = i
    lib.dsn_tap_sums.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.dsn_tap_sums.restype = i
    lib.dsn_gram.argtypes = [p, p, d, p, p, i, i, i, i, i, p]
    lib.dsn_gram.restype = i
    lib.dsn_moments.argtypes = [p, p, p, p, i, i, d, f, p, p, p, p, p]
    lib.dsn_moments.restype = i
    return lib


@functools.cache
def _concurrency(device_index: int, threads: int) -> int:
    """Once a device and block size: the gram kernel's attributes set, and
    its blocks resident on the whole card at once."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().dsn_prepare(threads, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"dsn_gram set-up failed (CUDA error {err}, {blocks.value} blocks)")
    return blocks.value * torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _plan(b: int, c: int, h: int, w: int, device_index: int):
    """A shape's band rows, and the scratch's byte offsets (a counter, then
    plane sums, tap sums, the bands' partial tiles and G_m) and size."""
    k = c * TAPS
    groups = -(-c // GROUP)
    pairs = groups * (groups + 1) // 2
    threads = _lib().dsn_gram_threads(c)
    rows = band_rows(h, w, b * pairs, _concurrency(device_index, threads))
    slices = b * -(-h // rows)
    offsets, end = [], 0
    for n in (4, 8 * b * k, 8 * k, 4 * slices * pairs * TAPS * TAPS * threads, 8 * k * k):
        offsets.append(end)
        end += -(-n // 256) * 256
    return rows, offsets, end


_scratch: dict = {}  # (device index, stream) -> uint8 tensor, its counter zero between calls


def _scratch_for(dev: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    buf = _scratch.get((dev.index, stream))
    if buf is None or buf.numel() < nbytes:
        buf = _scratch[(dev.index, stream)] = torch.zeros(nbytes, device=dev, dtype=torch.uint8)
    return buf


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def conv3x3_batch_moments_cuda(x: torch.Tensor, weight: torch.Tensor,
                               bias: Optional[torch.Tensor], running: Running = None,
                               momentum: float = 0.1):
    """The kernel route: ``(mean, var)`` as float64 CUDA tensors, and the
    running buffers advanced in place when given; no host read-back."""
    _check(x, weight, bias, running)
    lib = _lib()
    b, c, h, w = x.shape
    o = weight.shape[0]
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    shard = current_shard()
    count = float((b if shard is None else shard.batch) * h * w)
    rows, offsets, nbytes = _plan(b, c, h, w, dev.index)
    buf = _scratch_for(dev, stream, nbytes)
    counter, plane, tap, partial, G = (buf.data_ptr() + n for n in offsets)
    out = torch.empty(2 * o, device=dev, dtype=torch.float64)
    mean, var = out.split(o)

    _raise_on(lib.dsn_tap_sums(x.data_ptr(), plane, tap, counter, b, c, h, w, stream), "dsn_tap_sums")
    if shard is not None:
        taps = buf[offsets[2]:offsets[2] + 8 * c * TAPS].view(torch.float64)
        taps.copy_(shard.sum(taps))
    _raise_on(lib.dsn_gram(x.data_ptr(), tap, count, partial, G, b, c, h, w, rows, stream), "dsn_gram")
    if shard is not None:
        gram = buf[offsets[4]:offsets[4] + 8 * (c * TAPS) ** 2].view(torch.float64)
        gram.copy_(shard.sum(gram))
    rm, rv = (None, None) if running is None else (running[0].data_ptr(), running[1].data_ptr())
    _raise_on(lib.dsn_moments(G, tap, weight.data_ptr(), None if bias is None else bias.data_ptr(), o, c,
                              count, momentum, rm, rv, mean.data_ptr(), var.data_ptr(), stream),
              "dsn_moments")
    launches["dsn_stats"] += 1
    return mean, var


def conv3x3_batch_moments(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                          running: Running = None, momentum: float = 0.1):
    """The batch mean and biased variance (float64, one per output channel)
    of ``conv2d(x, weight, bias, padding=1)``, without forming it; with
    ``running = (mean, var)`` buffers, those advance in place as BatchNorm's
    do. CPU tensors take the plain twin, CUDA tensors the kernels."""
    if x.device.type == "cpu":
        return conv3x3_batch_moments_plain(x, weight, bias, running, momentum)
    return conv3x3_batch_moments_cuda(x, weight, bias, running, momentum)
