"""Gaussian filtering on the permutohedral lattice (host C++, bound with ctypes).

Counterpart of ``fedicra_tpu/native/__init__.py::permutohedral_filter``: the
same source (``csrc/permutohedral.cpp``, built with g++ by ``ops/_build.py``
on first use), so the same inputs give the same bits. It approximates
y_i = sum_j exp(-||p_i - p_j||^2 / 2) v_j (Adams et al. 2010) on the host,
one thread per batch element, as JAX's engine and the reference's vendored
lattice (utils/pytorch/wrapper/bilateralfilter/) do; it is no kernel of the
card. Tensors on the card are copied to the host and the result back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_host_library


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_host_library("permutohedral")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.permutohedral_filter_batch.argtypes = [p, p, p, i, i, i, i]
    lib.permutohedral_filter_batch.restype = None
    return lib


def permutohedral_filter(positions: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Filter ``values`` [B, N, c] or [N, c] at ``positions`` [B, N, d] or
    [N, d] (features already divided by their bandwidths); float32, on the
    input's device. Not differentiable (the lattice has no VJP of its own;
    the dense-CRF loss forms its gradient from a second filtering)."""
    if positions.ndim not in (2, 3) or values.ndim != positions.ndim:
        raise ValueError(f"positions {tuple(positions.shape)} and values {tuple(values.shape)}: "
                         "expected [B, N, d] and [B, N, c], or [N, d] and [N, c]")
    if positions.shape[:-1] != values.shape[:-1]:
        raise ValueError(f"positions {tuple(positions.shape)} and values {tuple(values.shape)} "
                         "differ in their leading dimensions")
    squeeze = positions.ndim == 2
    pos = positions.detach().to("cpu", torch.float32).contiguous()
    val = values.detach().to("cpu", torch.float32).contiguous()
    if squeeze:
        pos, val = pos[None], val[None]
    b, n, d = pos.shape
    out = torch.zeros_like(val)
    _lib().permutohedral_filter_batch(pos.data_ptr(), val.data_ptr(), out.data_ptr(),
                                      b, n, d, val.shape[2])
    return (out[0] if squeeze else out).to(values.device)
