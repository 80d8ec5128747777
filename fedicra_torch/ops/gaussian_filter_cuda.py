"""Exact Gaussian kernel filter (dense-CRF message passing): the CUDA kernel,
its plain twin, autograd.

Replaces the Pallas TPU kernel ``_filter_kernel`` of
``fedicra_tpu/ops/pallas_kernels.py`` with ``csrc/gaussian_filter.cu``
(route: CUDA C++ for sm_90a, built by ``ops/_build.py`` and bound with
ctypes). With features ``feats`` (B, N, D) and values (B, N, C), float32::

    out[b, i] = sum_j exp(-1/2 ||f[b, i] - f[b, j]||^2) v[b, j]

The kernel matrix is symmetric and the filter linear in the values, so the
gradient to the values is the same filter of the cotangent; the features
get none (the dense-CRF loss treats them as constants).

``gaussian_kernel_filter`` takes the plain twin for CPU tensors and the
kernel for CUDA tensors; for a CUDA tensor it launches the kernel or
raises. ``launches`` counts kernel launches, the backward's included.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ._build import load_library

FEATURE_DIMS = (3, 4, 5)
MAX_CHANNELS = 4

launches = {"gaussian_filter": 0}


def reset_launches() -> None:
    launches["gaussian_filter"] = 0


@contextlib.contextmanager
def _ieee_fp32_matmul():
    """Full fp32 products on the card (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gaussian_filter_plain(feats: torch.Tensor, values: torch.Tensor, tn: int = 2048) -> torch.Tensor:
    """The kernel's plain twin, as ``_gaussian_filter_xla``: chunks of ``tn``
    columns, exp(f_i.f_j - |f_i|^2/2 - |f_j|^2/2) by ``torch.matmul``.

    Takes (N, D) / (N, C) or batched (B, N, D) / (B, N, C).
    """
    if feats.ndim == 2:
        return gaussian_filter_plain(feats[None], values[None], tn)[0]
    norms = torch.sum(feats * feats, dim=-1, keepdim=True)
    out = torch.zeros_like(values)
    with _ieee_fp32_matmul():
        for j in range(0, feats.shape[1], tn):
            ks, kn, vs = feats[:, j:j + tn], norms[:, j:j + tn], values[:, j:j + tn]
            s = feats @ ks.transpose(1, 2) - 0.5 * norms - 0.5 * kn.transpose(1, 2)
            out = out + torch.exp(s) @ vs
    return out


def _check(feats: torch.Tensor, values: torch.Tensor) -> None:
    for name, t in (("feats", feats), ("values", values)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D (B, N, channels) tensor")
    if feats.device != values.device:
        raise ValueError(f"feats on {feats.device} but values on {values.device}")
    if feats.shape[:2] != values.shape[:2]:
        raise ValueError(f"feats {tuple(feats.shape)} and values {tuple(values.shape)} differ in B, N")
    if feats.shape[2] not in FEATURE_DIMS:
        raise ValueError(f"kernel takes {FEATURE_DIMS} feature dims, got {feats.shape[2]}")
    if not 1 <= values.shape[2] <= MAX_CHANNELS:
        raise ValueError(f"kernel takes 1..{MAX_CHANNELS} value channels, got {values.shape[2]}")
    if not 1 <= feats.shape[0] <= 65535 or feats.shape[1] < 1:
        raise ValueError(f"kernel takes 1..65535 images of at least one point, got {tuple(feats.shape)}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("gaussian_filter")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gaussian_filter_workspace.argtypes = [i, i, i, i, i]
    lib.gaussian_filter_workspace.restype = ctypes.c_longlong
    lib.gaussian_filter.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.gaussian_filter.restype = i
    return lib


@functools.cache
def _workspace_floats(b: int, n: int, d: int, c: int, device_index: int) -> int:
    """Floats of workspace the kernel's plan for this shape needs on this
    card: the column shares of the images it splits (0: none)."""
    size = _lib().gaussian_filter_workspace(b, n, d, c, device_index)
    if size < 0:
        raise RuntimeError(f"gaussian_filter cannot plan B={b} N={n} D={d} C={c} on cuda:{device_index}")
    return size


def gaussian_filter_cuda(feats: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on (B, N, D) features and (B, N, C) values: one
    call, counted once in ``launches``, though where its plan splits the
    last images' columns into shares it runs three CUDA kernels (whole
    blocks, shares, and their fixed-order sum)."""
    _check(feats, values)
    lib = _lib()
    b, n, d = feats.shape
    c, dev = values.shape[2], feats.device.index
    out = torch.empty_like(values)
    size = _workspace_floats(b, n, d, c, dev)
    ws = torch.empty(size, dtype=torch.float32, device=feats.device) if size else None
    err = lib.gaussian_filter(
        feats.data_ptr(), values.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        b, n, d, c, dev, torch.cuda.current_stream(feats.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gaussian_filter launch failed with CUDA error {err}")
    launches["gaussian_filter"] += 1
    return out


class _GaussianFilter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, values):
        ctx.save_for_backward(feats)
        return gaussian_filter_cuda(feats, values)

    @staticmethod
    def backward(ctx, g):
        (feats,) = ctx.saved_tensors
        return None, gaussian_filter_cuda(feats, g.contiguous())


def gaussian_kernel_filter(feats: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out_i = sum_j exp(-||f_i - f_j||^2 / 2) v_j (exact, self included).

    (N, D) / (N, C) or batched (B, N, D) / (B, N, C); differentiable in
    ``values`` only. CPU tensors take the plain twin; CUDA tensors launch
    the kernel, which raises on what it does not take. There is no fallback
    between them.
    """
    if feats.device.type == "cpu" and values.device.type == "cpu":
        return gaussian_filter_plain(feats.detach(), values)
    if feats.ndim == 2:
        return gaussian_kernel_filter(feats[None], values[None])[0]
    return _GaussianFilter.apply(feats.detach().contiguous(), values.contiguous())


def bilateral_features(image: torch.Tensor, sigma_rgb: float, sigma_xy: float) -> torch.Tensor:
    """[x/sigma_xy, y/sigma_xy, rgb/sigma_rgb] of a (..., H, W, C) image,
    flattened to (..., H*W, 2 + C); x is the column index."""
    *lead, h, w, c = image.shape
    cols = torch.arange(w, dtype=image.dtype, device=image.device)[None, :].expand(h, w)
    rows = torch.arange(h, dtype=image.dtype, device=image.device)[:, None].expand(h, w)
    xy = torch.stack([cols / sigma_xy, rows / sigma_xy], dim=-1).expand(*lead, h, w, 2)
    return torch.cat([xy, image / sigma_rgb], dim=-1).reshape(*lead, h * w, 2 + c)
