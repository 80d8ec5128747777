"""A deep-supervision head's epilogue after its 3x3 convolution: BatchNorm,
ReLU, Dropout2d and the 1x1 convolution, by the CUDA kernels of
``csrc/dsn_epilogue.cu`` and by their plain twin.

``DSNHead.forward`` (``models/blocks.py``) convolves, draws its Dropout2d
keep mask, and hands the convolution's output y (B, C, H, W) to
``dsn_epilogue``. The plain twin is the head's composition of PyTorch
operations: ``BatchNorm``, ``F.relu``, ``h * keep / (1 - p)`` and the 1x1
``F.conv2d``; CPU tensors take it. A CUDA fp32 y takes the kernels, as one
``torch.autograd.Function`` whose backward is kernels too; the wrapper
raises on what they do not take (other dtypes, more than
``max_channels()`` channels or ``max_classes()`` classes); nothing falls
back. The kernels form none of the chain's C-channel maps: the forward reads
y for the batch statistics (train mode) and once more for the output, and
the backward keeps y alone, reads it twice and writes its gradient.

Under a data shard (``parallel/data_axis.py``) the batch statistics' sums
and, for y's gradient, the BatchNorm parameters' gradient sums are summed
over the group between launches, as ``BatchNorm`` sums its moments; the
parameters' gradients returned are the rank's own, which the trainer sums.
``launches`` counts forward calls of the kernel route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.data_axis import current_shard
from ._build import load_library

launches = {"dsn_epilogue": 0}


def reset_launches() -> None:
    launches["dsn_epilogue"] = 0


def dsn_epilogue_plain(y: torch.Tensor, bn, weight: torch.Tensor, keep: Optional[torch.Tensor],
                       p: float) -> torch.Tensor:
    """The head's composition: ``bn`` (a ``BatchNorm`` in its own mode),
    ReLU, the keep mask's product over ``1 - p`` where ``keep`` is given,
    then the 1x1 convolution by ``weight`` (K, C, 1, 1)."""
    h = F.relu(bn(y))
    if keep is not None:
        h = h * keep / (1.0 - p)
    return F.conv2d(h, weight)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("dsn_epilogue")
    p, i, d, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_float
    for name in ("dsn_epilogue_max_classes", "dsn_epilogue_max_channels"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.dsn_epilogue_slices.argtypes = [i, i]
    lib.dsn_epilogue_slices.restype = i
    lib.dsn_epilogue_plane_moments.argtypes = [p, i, i, i, i, p, p]
    lib.dsn_epilogue_moments.argtypes = [p, i, i, d, f, f, p, p, p, p, p, p]
    lib.dsn_epilogue_forward.argtypes = [p, p, p, p, p, p, p, f, i, i, i, i, i, p, p]
    lib.dsn_epilogue_grad_params.argtypes = [p, p, p, p, p, p, p, p, f, i, i, i, i, i, p, p, p, p]
    lib.dsn_epilogue_grad_input.argtypes = [p, p, p, p, p, p, p, p, f, i, i, i, i, i, p, i, d, p, p]
    for name in ("plane_moments", "moments", "forward", "grad_params", "grad_input"):
        getattr(lib, f"dsn_epilogue_{name}").restype = i
    return lib


def max_classes() -> int:
    return _lib().dsn_epilogue_max_classes()


def max_channels() -> int:
    return _lib().dsn_epilogue_max_channels()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _vec(*tensors: torch.Tensor) -> int:
    """4 where every pixel plane starts on 16 bytes (16-byte loads), else 1."""
    hw = tensors[0].shape[-1] * tensors[0].shape[-2]
    return 4 if hw % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _check(y, bn, weight, keep) -> None:
    named = {"y": y, "BatchNorm weight": bn.weight, "BatchNorm bias": bn.bias,
             "running mean": bn.running_mean, "running var": bn.running_var, "1x1 weight": weight}
    if keep is not None:
        named["keep"] = keep
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != y.device:
            raise ValueError(f"{name} must be a CUDA tensor on y's device, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if y.ndim != 4:
        raise ValueError(f"y must be (B, C, H, W), got {tuple(y.shape)}")
    b, c = y.shape[:2]
    k = weight.shape[0]
    if weight.shape != (k, c, 1, 1):
        raise ValueError(f"weight {tuple(weight.shape)} is not a 1x1 conv of {c} channels")
    if not 1 <= k <= max_classes():
        raise ValueError(f"{k} classes: the kernels hold 1 to {max_classes()}")
    if c > max_channels():
        raise ValueError(f"{c} channels: the kernels hold at most {max_channels()}")
    if bn.weight.shape != (c,) or bn.running_mean.shape != (c,):
        raise ValueError(f"BatchNorm of {bn.weight.shape[0]} channels on {c}")
    if keep is not None and keep.shape != (b, c, 1, 1):
        raise ValueError(f"keep {tuple(keep.shape)} is not Dropout2d's mask of y {tuple(y.shape)}")


class _Epilogue(torch.autograd.Function):
    """The kernels' forward and backward; see the module's docstring."""

    @staticmethod
    def forward(ctx, y, gamma, beta, weight, keep, bn, p):
        lib = _lib()
        b, c, h, w = y.shape
        hw, k = h * w, weight.shape[0]
        dev = y.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        vec = _vec(y)
        shard = current_shard()
        count = float((b if shard is None else shard.batch) * hw)
        if bn.training:
            partial = torch.empty(b * c * 2, device=dev, dtype=torch.float64)
            _raise_on(lib.dsn_epilogue_plane_moments(y.data_ptr(), b, c, hw, vec, partial.data_ptr(), stream),
                      "dsn_epilogue_plane_moments")
            mean, rstd = torch.empty(2 * c, device=dev, dtype=torch.float32).split(c)
            running = (bn.running_mean.data_ptr(), bn.running_var.data_ptr(), mean.data_ptr(), rstd.data_ptr())
            if shard is None:
                err = lib.dsn_epilogue_moments(partial.data_ptr(), b, c, count, bn.eps, bn.momentum, None,
                                               *running, stream)
            else:  # this rank's sums, then the group's
                sums = torch.empty(2 * c, device=dev, dtype=torch.float64)
                _raise_on(lib.dsn_epilogue_moments(partial.data_ptr(), b, c, count, bn.eps, bn.momentum,
                                                   sums.data_ptr(), None, None, None, None, stream),
                          "dsn_epilogue_moments")
                sums = shard.sum(sums)
                err = lib.dsn_epilogue_moments(None, 0, c, count, bn.eps, bn.momentum, sums.data_ptr(),
                                               *running, stream)
            _raise_on(err, "dsn_epilogue_moments")
        else:
            mean, rstd = bn.running_mean.clone(), torch.rsqrt(bn.running_var + bn.eps)
        inv_q = float(np.float32(1.0) / np.float32(1.0 - p)) if keep is not None else 1.0
        aux = torch.empty(b, k, h, w, device=dev, dtype=torch.float32)
        _raise_on(lib.dsn_epilogue_forward(y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
                                           beta.data_ptr(), weight.data_ptr(), _ptr(keep), inv_q, b, c, hw, k,
                                           vec, aux.data_ptr(), stream),
                  "dsn_epilogue_forward")
        launches["dsn_epilogue"] += 1
        ctx.save_for_backward(y, gamma, beta, weight, keep, mean, rstd)
        # the backward may run on autograd's own thread, where the caller's
        # shard context is not set
        ctx.training, ctx.inv_q, ctx.count, ctx.shard = bn.training, inv_q, count, shard
        return aux

    @staticmethod
    def backward(ctx, grad):
        lib = _lib()
        y, gamma, beta, weight, keep, mean, rstd = ctx.saved_tensors
        g = grad.contiguous()
        b, c, h, w = y.shape
        hw, k = h * w, weight.shape[0]
        dev = y.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        vec = _vec(y, g)
        common = (y.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), weight.data_ptr(), _ptr(keep), ctx.inv_q, b, c, hw, k, vec)
        partial = torch.empty(lib.dsn_epilogue_slices(b, hw) * c * (k + 2), device=dev, dtype=torch.float32)
        sums = torch.empty(c, k + 2, device=dev, dtype=torch.float64)
        grads = torch.empty(k + 2, c, device=dev, dtype=torch.float32)
        _raise_on(lib.dsn_epilogue_grad_params(*common, partial.data_ptr(), sums.data_ptr(), grads.data_ptr(),
                                               stream),
                  "dsn_epilogue_grad_params")
        dy = None
        if ctx.needs_input_grad[0]:
            bn_sums, stride = None, 0  # eval mode: no batch statistics
            if ctx.training and ctx.shard is None:
                bn_sums, stride = sums[:, k:], k + 2  # each channel's dbeta and dgamma
            elif ctx.training:
                bn_sums, stride = ctx.shard.sum(sums[:, k:].contiguous()), 2
            dy = torch.empty_like(y)
            _raise_on(lib.dsn_epilogue_grad_input(*common, _ptr(bn_sums), stride, ctx.count, dy.data_ptr(), stream),
                      "dsn_epilogue_grad_input")
        dweight, dbeta, dgamma = grads[:k].view(k, c, 1, 1), grads[k], grads[k + 1]
        return dy, dgamma, dbeta, dweight, None, None, None


def dsn_epilogue_cuda(y: torch.Tensor, bn, weight: torch.Tensor, keep: Optional[torch.Tensor],
                      p: float) -> torch.Tensor:
    """The kernel route of ``dsn_epilogue``; in train mode it advances
    ``bn``'s running buffers in place."""
    _check(y, bn, weight, keep)
    keep2 = None if keep is None else keep.view(keep.shape[0], keep.shape[1])
    return _Epilogue.apply(y, bn.weight, bn.bias, weight, keep2, bn, p)


def dsn_epilogue(y: torch.Tensor, bn, weight: torch.Tensor, keep: Optional[torch.Tensor],
                 p: float) -> torch.Tensor:
    """A DSN head's output from its 3x3 convolution's output ``y``: ``bn``
    (``BatchNorm``, train or eval mode as it stands), ReLU, the Dropout2d
    mask ``keep`` (B, C, 1, 1) over ``1 - p`` (None: no dropout), and the
    1x1 convolution by ``weight`` (K, C, 1, 1), no bias. CPU tensors take
    the plain twin, CUDA tensors the kernels."""
    if y.device.type == "cpu":
        return dsn_epilogue_plain(y, bn, weight, keep, p)
    return dsn_epilogue_cuda(y, bn, weight, keep, p)
