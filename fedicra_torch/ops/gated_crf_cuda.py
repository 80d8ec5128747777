"""Gated CRF (Potts kernel, no masks): the fused CUDA kernel, its plain twins, autograd.

Replaces the Pallas TPU kernels ``_fwd_kernel`` / ``_bwd_kernel`` of
``fedicra_tpu/ops/gated_crf_pallas.py`` with one kernel in ``csrc/gated_crf.cu``
(route: CUDA C++ for sm_90a, built by ``ops/_build.py`` and bound with
ctypes) that gives the loss and the gradient's accumulator in one pass.

Layout is planes: ``y`` (B, C, H, W) probabilities, float32 or bfloat16 (the
softmax of bf16 logits under AMP), and ``feats`` (B, F, H, W) float32 guide
features. A bf16 ``y`` is widened once, exactly, as the kernel stages it;
from there on everything is the float32 arithmetic of a float32 ``y``, so
the loss and acc equal those of a float32 launch on ``y.float()`` bit for
bit. With offsets o != 0, |dy|, |dx| <= radius::

    k_o(q) = exp(-1/2 ||f(q+o) - f(q)||^2)         (y and f zero outside)
    K(q)   = sum_o k_o(q),   acc(q) = sum_o k_o(q) y(q+o)
    loss   = sum_b sum_q sum_o k_o(q) (1 - <y(q), y(q+o)>) / (B H W)
           = sum_b sum_q [K(q) - <y(q), acc(q)>] / (B H W)
    dL/dy  = -2 g / (B H W) * acc                    (no gradient to f)

``gated_crf_potts`` takes the plain PyTorch twin for CPU tensors and the
kernel for CUDA tensors; for a CUDA tensor it launches the kernel or raises.
The forward saves acc (float32) when ``y`` needs a gradient, so the backward
launches nothing; it returns dL/dy in ``y``'s dtype. ``launches`` counts
launches of the fused kernel, ``launches_by_dtype`` the same by ``y``'s dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load_library

MAX_CHANNELS = 4
FEATURE_CHANNELS = (3, 5)  # xy + 1 or 3 image channels
MAX_RADIUS = 5

Y_DTYPES = (torch.float32, torch.bfloat16)

launches = {"gated_crf": 0}
launches_by_dtype = {"float32": 0, "bfloat16": 0}


def reset_launches() -> None:
    launches["gated_crf"] = 0
    for k in launches_by_dtype:
        launches_by_dtype[k] = 0


def offset_windows(radius: int, h: int, w: int):
    """The index of each offset's window into (r-padded) planes, o != 0."""
    r = radius
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy or dx:
                yield (slice(None), slice(None), slice(r + dy, r + dy + h), slice(r + dx, r + dx + w))


def gated_crf_potts_plain(y: torch.Tensor, feats: torch.Tensor, radius: int) -> torch.Tensor:
    """The loss in plain PyTorch, pair by pair, streaming over the
    (2r+1)^2 - 1 offsets, on ``y`` widened to the features' dtype (as the
    kernel widens a bf16 ``y``); differentiable in ``y``. CPU tensors take it."""
    y = y.to(feats.dtype)
    b, _, h, w = y.shape
    pad = (radius,) * 4
    y_pad, f_pad = F.pad(y, pad), F.pad(feats, pad)
    total = y.new_zeros(())
    for win in offset_windows(radius, h, w):
        k = torch.exp(-0.5 * ((f_pad[win] - feats) ** 2).sum(dim=1))
        cross = (y_pad[win] * y).sum(dim=1)
        total = total + (k * (1.0 - cross)).sum()
    return total / (b * h * w)


@torch.no_grad()
def gated_crf_potts_fused_plain(y: torch.Tensor, feats: torch.Tensor, radius: int):
    """The fused kernel's plain twin: ``(loss, acc)``, streaming over the offsets.

    Widens ``y`` to the features' dtype, forms K and acc in it and the loss
    as the kernel does, sum_q [K(q) - <y(q), acc(q)>] with the per-pixel
    difference and the sum in float64; the loss comes back in the features'
    dtype. Not differentiable.
    """
    y = y.to(feats.dtype)
    b, _, h, w = y.shape
    pad = (radius,) * 4
    y_pad, f_pad = F.pad(y, pad), F.pad(feats, pad)
    k_sum = y.new_zeros((b, h, w))
    acc = torch.zeros_like(y)
    for win in offset_windows(radius, h, w):
        k = torch.exp(-0.5 * ((f_pad[win] - feats) ** 2).sum(dim=1))
        k_sum += k
        acc += k[:, None] * y_pad[win]
    per_pixel = k_sum.double() - (y.double() * acc.double()).sum(dim=1)
    return (per_pixel.sum() / (b * h * w)).to(y.dtype), acc


def _check(y: torch.Tensor, feats: torch.Tensor, radius: int) -> None:
    for name, t, dtypes in (("y", y, Y_DTYPES), ("feats", feats, (torch.float32,))):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in dtypes:
            names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise ValueError(f"{name} must be {names}, got {t.dtype}")
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D (B, C, H, W) tensor")
    if y.device != feats.device:
        raise ValueError(f"y on {y.device} but feats on {feats.device}")
    if (y.shape[0],) + tuple(y.shape[2:]) != (feats.shape[0],) + tuple(feats.shape[2:]):
        raise ValueError(f"y {tuple(y.shape)} and feats {tuple(feats.shape)} differ in B, H, W")
    if not 1 <= y.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"kernel takes 1..{MAX_CHANNELS} classes, got {y.shape[1]}")
    if feats.shape[1] not in FEATURE_CHANNELS:
        raise ValueError(f"kernel takes {FEATURE_CHANNELS} feature channels, got {feats.shape[1]}")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"kernel takes radius 1..{MAX_RADIUS}, got {radius}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("gated_crf")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gated_crf_num_tiles.argtypes = [i, i, i]
    lib.gated_crf_num_tiles.restype = i
    lib.gated_crf_fused.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.gated_crf_fused.restype = i
    return lib


@functools.cache
def _done_counter(device_index: int, stream: int) -> torch.Tensor:
    """The kernel's finished-blocks counter for one stream: zeroed here once,
    left at 0 by every launch."""
    return torch.zeros((), dtype=torch.int32, device=torch.device("cuda", device_index))


def gated_crf_fused_cuda(y: torch.Tensor, feats: torch.Tensor, radius: int, need_acc: bool = True):
    """Launch the fused kernel: ``(loss, acc)``, the 0-dim float32 loss and
    float32 acc (B, C, H, W), or ``(loss, None)`` when ``need_acc`` is false
    (acc is then formed in registers and not written)."""
    _check(y, feats, radius)
    lib = _lib()
    b, c, h, w = y.shape
    stream = torch.cuda.current_stream(y.device).cuda_stream
    partial = torch.empty(lib.gated_crf_num_tiles(b, h, w), device=y.device, dtype=torch.float64)
    loss = torch.empty((), device=y.device, dtype=torch.float32)
    acc = torch.empty(y.shape, device=y.device, dtype=torch.float32) if need_acc else None
    err = lib.gated_crf_fused(
        y.data_ptr(), int(y.dtype == torch.bfloat16), feats.data_ptr(),
        None if acc is None else acc.data_ptr(),
        partial.data_ptr(), _done_counter(y.device.index, stream).data_ptr(), loss.data_ptr(),
        b, c, feats.shape[1], h, w, radius, y.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"gated_crf_fused launch failed with CUDA error {err}")
    launches["gated_crf"] += 1
    launches_by_dtype[str(y.dtype).replace("torch.", "")] += 1
    return loss, acc


class _GatedCRFPotts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, feats, radius):
        loss, acc = gated_crf_fused_cuda(y, feats, radius)
        ctx.save_for_backward(acc)
        ctx.y_dtype = y.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        (acc,) = ctx.saved_tensors
        b, _, h, w = acc.shape
        # out of place: the saved acc must outlive a backward (retain_graph);
        # formed in float32, then rounded to y's dtype
        return (acc * (g * (-2.0 / (b * h * w)))).to(ctx.y_dtype), None, None


def _gated_crf_potts_kernel(y: torch.Tensor, feats: torch.Tensor, radius: int) -> torch.Tensor:
    """The kernel route: acc is written and saved only when ``y`` will get a
    gradient (grad mode on and ``y`` requiring one)."""
    y, feats = y.contiguous(), feats.detach().contiguous()
    if torch.is_grad_enabled() and y.requires_grad:
        return _GatedCRFPotts.apply(y, feats, radius)
    return gated_crf_fused_cuda(y, feats, radius, need_acc=False)[0]


def gated_crf_potts(y: torch.Tensor, feats: torch.Tensor, radius: int) -> torch.Tensor:
    """The gated CRF loss on planes; differentiable in ``y`` only.

    CPU tensors take the plain twin; CUDA tensors launch the kernel (which
    raises on what it does not take). There is no fallback between them.
    """
    if y.device.type == "cpu" and feats.device.type == "cpu":
        return gated_crf_potts_plain(y, feats, radius)
    return _gated_crf_potts_kernel(y, feats, radius)
