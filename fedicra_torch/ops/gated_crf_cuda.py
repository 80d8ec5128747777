"""Gated CRF (Potts kernel, no masks): the CUDA kernel, its plain twin, autograd.

Replaces the Pallas TPU kernels ``_fwd_kernel`` / ``_bwd_kernel`` of
``fedicra_tpu/ops/gated_crf_pallas.py`` with ``csrc/gated_crf.cu`` (route:
CUDA C++ for sm_90a, built by ``ops/_build.py`` and bound with ctypes).

Layout is planes: ``y`` (B, C, H, W) probabilities and ``feats`` (B, F, H, W)
guide features, both float32. With offsets o != 0, |dy|, |dx| <= radius::

    k_o(q) = exp(-1/2 ||f(q+o) - f(q)||^2)         (y and f zero outside)
    loss   = sum_b sum_q sum_o k_o(q) (1 - <y(q), y(q+o)>) / (B H W)
    dL/dy  = -2 g / (B H W) * sum_o k_o(q) y(q+o)     (no gradient to f)

``gated_crf_potts`` takes the plain PyTorch twin for CPU tensors and the
kernel for CUDA tensors; for a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches of the forward and the backward.
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

launches = {"gated_crf_fwd": 0, "gated_crf_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def gated_crf_potts_plain(y: torch.Tensor, feats: torch.Tensor, radius: int) -> torch.Tensor:
    """The kernel's plain PyTorch twin, streaming over the (2r+1)^2 - 1 offsets."""
    b, _, h, w = y.shape
    r = radius
    pad = (r, r, r, r)
    y_pad = F.pad(y, pad)
    f_pad = F.pad(feats, pad)
    f0 = feats
    total = y.new_zeros(())
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            win = (slice(None), slice(None), slice(r + dy, r + dy + h), slice(r + dx, r + dx + w))
            k = torch.exp(-0.5 * ((f_pad[win] - f0) ** 2).sum(dim=1))
            cross = (y_pad[win] * y).sum(dim=1)
            total = total + (k * (1.0 - cross)).sum()
    return total / (b * h * w)


def _check(y: torch.Tensor, feats: torch.Tensor, radius: int) -> None:
    for name, t in (("y", y), ("feats", feats)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
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
    lib.gated_crf_num_partials.argtypes = [i, i, i]
    lib.gated_crf_num_partials.restype = i
    lib.gated_crf_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.gated_crf_fwd.restype = i
    lib.gated_crf_bwd.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.gated_crf_bwd.restype = i
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gated_crf_fwd_cuda(y: torch.Tensor, feats: torch.Tensor, radius: int) -> torch.Tensor:
    """Launch the forward kernel: the 0-dim loss sum_b S_b / (B H W)."""
    _check(y, feats, radius)
    lib = _lib()
    b, c, h, w = y.shape
    partial = torch.empty(lib.gated_crf_num_partials(b, h, w), device=y.device, dtype=torch.float32)
    loss = torch.empty((), device=y.device, dtype=torch.float32)
    err = lib.gated_crf_fwd(
        y.data_ptr(), feats.data_ptr(), partial.data_ptr(), loss.data_ptr(),
        b, c, feats.shape[1], h, w, radius, y.device.index, _stream(y),
    )
    if err != 0:
        raise RuntimeError(f"gated_crf_fwd launch failed with CUDA error {err}")
    launches["gated_crf_fwd"] += 1
    return loss


def gated_crf_bwd_cuda(y: torch.Tensor, feats: torch.Tensor, radius: int) -> torch.Tensor:
    """Launch the backward kernel: acc(q) = sum_o k_o(q) y(q+o), (B, C, H, W)."""
    _check(y, feats, radius)
    lib = _lib()
    b, c, h, w = y.shape
    acc = torch.empty_like(y)
    err = lib.gated_crf_bwd(
        y.data_ptr(), feats.data_ptr(), acc.data_ptr(),
        b, c, feats.shape[1], h, w, radius, y.device.index, _stream(y),
    )
    if err != 0:
        raise RuntimeError(f"gated_crf_bwd launch failed with CUDA error {err}")
    launches["gated_crf_bwd"] += 1
    return acc


class _GatedCRFPotts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, feats, radius):
        ctx.save_for_backward(y, feats)
        ctx.radius = radius
        return gated_crf_fwd_cuda(y, feats, radius)

    @staticmethod
    def backward(ctx, g):
        y, feats = ctx.saved_tensors
        acc = gated_crf_bwd_cuda(y, feats, ctx.radius)
        b, _, h, w = y.shape
        return acc.mul_(g * (-2.0 / (b * h * w))), None, None


def gated_crf_potts(y: torch.Tensor, feats: torch.Tensor, radius: int) -> torch.Tensor:
    """The gated CRF loss on planes; differentiable in ``y`` only on CUDA.

    CPU tensors take the plain twin; CUDA tensors launch the kernel (which
    raises on what it does not take). There is no fallback between them.
    """
    if y.device.type == "cpu" and feats.device.type == "cpu":
        return gated_crf_potts_plain(y, feats, radius)
    return _GatedCRFPotts.apply(y.contiguous(), feats.detach().contiguous(), radius)
