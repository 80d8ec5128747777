"""Convolutional building blocks of the U-Net family (NCHW inside the model).

Counterpart of ``fedicra_tpu/models/blocks.py``. Module and parameter names
follow the flax tree so that ``fedicra_torch.convert`` maps one onto the
other by rule.

Dropout draws from an explicit ``torch.Generator`` handed down the forward
pass; ``None`` uses PyTorch's default generator.

Mixed precision follows JAX's cast points, not ``torch.autocast``'s: inside
``with compute_dtype(torch.bfloat16):`` every ``Conv`` (and so every 1x1
conv of PCS, every ``out_conv``) computes and returns bf16 from fp32
parameters; ``BatchNorm`` casts its input to fp32; ``DSNHead`` and the
bare ``nn.Conv2d`` of other models stay fp32, as JAX's do.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.data_axis import batch_draw, current_shard

LRELU_SLOPE = 0.01  # torch nn.LeakyReLU default negative_slope
BN_MOMENTUM = 0.1
BN_EPS = 1e-5

_COMPUTE_DTYPE: contextvars.ContextVar[Optional[torch.dtype]] = contextvars.ContextVar(
    "compute_dtype", default=None
)


@contextlib.contextmanager
def compute_dtype(dtype: Optional[torch.dtype]) -> Iterator[None]:
    """Within the block, ``Conv`` computes in ``dtype`` (None: the input's)."""
    token = _COMPUTE_DTYPE.set(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE.reset(token)


def get_compute_dtype() -> Optional[torch.dtype]:
    return _COMPUTE_DTYPE.get()


class Conv(nn.Conv2d):
    """``nn.Conv2d`` that computes in the context's compute dtype.

    With one set, the input and weight are cast to it and the bias is added
    after the convolution, in that dtype: flax's ``Conv(dtype=...)`` rounds
    the convolution before its bias add, and so does this. The convolution
    of the rounded operands is summed in fp32 and rounded once, as XLA's
    bf16 convolution is: cuDNN's bf16 kernels do so on the card; on the CPU,
    where torch's bf16 kernel rounds elsewhere, it runs in fp32 and rounds.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = get_compute_dtype()
        if dtype is None:
            return super().forward(x)
        x, w = x.to(dtype), self.weight.to(dtype)
        if x.device.type == "cpu":
            out = self._conv_forward(x.float(), w.float(), None).to(dtype)
        else:
            out = self._conv_forward(x, w, None)
        if self.bias is not None:
            out = out + self.bias.to(dtype)[:, None, None]
        return out


def dropout(
    x: torch.Tensor,
    p: float,
    generator: Optional[torch.Generator],
    *,
    channels: bool = False,
) -> torch.Tensor:
    """Inverted dropout; ``channels=True`` drops whole channels (Dropout2d)."""
    if p == 0.0:
        return x
    shape = x.shape[:2] + (1, 1) if channels else x.shape

    def draw(shape):
        keep = torch.empty(shape, device=x.device, dtype=x.dtype)
        return keep.bernoulli_(1.0 - p, generator=generator)

    return x * batch_draw(draw, shape) / (1.0 - p)


class BatchNorm(nn.Module):
    """BatchNorm2d with flax's running-variance rule, in its parameters' dtype
    (fp32) whatever its input's.

    ``momentum`` is torch's (flax's momentum is 1 - it). flax updates the
    running variance with the *biased* batch variance; ``F.batch_norm``
    would fold in the unbiased one. The batch statistics are taken from
    ``F.batch_norm`` itself (momentum 1 into scratch buffers) and the
    running buffers are updated here by hand.

    Under a data shard (``parallel/data_axis.py``) the batch statistics are
    the whole client batch's: the mean, then the centred sum of squares,
    each summed over the data group with a gradient through the sum.
    """

    def __init__(self, num_features: int, eps: float = BN_EPS, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)  # fp32 under AMP, as JAX's BatchNorm casts
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                training=False, eps=self.eps,
            )
        shard = current_shard()
        if shard is not None:
            return self._forward_sharded(x, shard)
        mean = torch.zeros_like(self.running_mean)
        var_unbiased = torch.zeros_like(self.running_var)
        out = F.batch_norm(
            x, mean, var_unbiased, self.weight, self.bias,
            training=True, momentum=1.0, eps=self.eps,
        )
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var_unbiased, alpha=m * (n - 1) / n)
        return out

    def _forward_sharded(self, x: torch.Tensor, shard) -> torch.Tensor:
        n = shard.batch * x[0, 0].numel()
        mean = shard.sum(x.sum(dim=(0, 2, 3))) / n
        centred = x - mean[:, None, None]
        var = shard.sum((centred * centred).sum(dim=(0, 2, 3))) / n
        scale = self.weight * torch.rsqrt(var + self.eps)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return centred * scale[:, None, None] + self.bias[:, None, None]


def conv(in_ch: int, out_ch: int, kernel_size: int = 3, bias: bool = True) -> Conv:
    """'SAME'-padded stride-1 ``Conv``."""
    return Conv(in_ch, out_ch, kernel_size, padding=kernel_size // 2, bias=bias)


class ConvBNAct(nn.Module):
    """Conv3x3 -> BN -> LeakyReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = conv(in_ch, out_ch)
        self.norm = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.norm(self.conv(x)), LRELU_SLOPE)


class ConvBlock(nn.Module):
    """ConvBNAct -> Dropout -> ConvBNAct (dropout between the halves only)."""

    def __init__(self, in_ch: int, out_ch: int, dropout_p: float):
        super().__init__()
        self.conv1 = ConvBNAct(in_ch, out_ch)
        self.conv2 = ConvBNAct(out_ch, out_ch)
        self.dropout_p = dropout_p

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.conv1(x)
        if self.training:
            x = dropout(x, self.dropout_p, generator)
        return self.conv2(x)


class DownBlock(nn.Module):
    """2x2 max-pool, then ConvBlock."""

    def __init__(self, in_ch: int, out_ch: int, dropout_p: float):
        super().__init__()
        self.block = ConvBlock(in_ch, out_ch, dropout_p)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self.block(F.max_pool2d(x, 2), generator)


class UpBlock(nn.Module):
    """1x1 conv, align-corners bilinear upsampling to the skip, concat, ConvBlock.

    Only the bilinear variant is ported: it is the live one (PARITY #11).
    """

    def __init__(self, low_ch: int, skip_ch: int, out_ch: int, dropout_p: float = 0.0):
        super().__init__()
        self.conv1x1 = conv(low_ch, skip_ch, kernel_size=1)
        self.block = ConvBlock(2 * skip_ch, out_ch, dropout_p)

    def forward(self, x_low, x_skip, generator=None) -> torch.Tensor:
        x_low = resize_bilinear_align_corners(self.conv1x1(x_low), *x_skip.shape[-2:])
        return self.block(torch.cat([x_skip, x_low], dim=1), generator)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch's align_corners=True bilinear resize of NCHW ``x``.

    In bf16 (under AMP) it is written as JAX's: the weights in bf16, rows
    then columns, each product and sum rounded, where ``F.interpolate``
    would round once.
    """
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    if x.dtype != torch.bfloat16:
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)

    def taps(n: int, out: int):
        scale = (n - 1) / (out - 1) if out > 1 else 0.0
        pos = torch.arange(out, dtype=torch.float32, device=x.device) * scale
        i0 = pos.floor().long().clamp(0, n - 1)
        return i0, (i0 + 1).clamp(max=n - 1), (pos - i0).to(x.dtype)

    r0, r1, fr = taps(h, out_h)
    c0, c1, fc = taps(w, out_w)
    fr = fr[:, None]
    top = x[:, :, r0] * (1 - fr) + x[:, :, r1] * fr
    return top[..., c0] * (1 - fc) + top[..., c1] * fc


class DSNHead(nn.Module):
    """Deep-supervision head: Conv3x3 -> BN -> ReLU -> Dropout2d -> Conv1x1 (no bias).

    Written plainly, without the TPU version's row tiling. fp32 under any
    compute dtype: JAX's head convolves by ``lax`` itself, out of AMP's reach.
    """

    def __init__(self, in_ch: int, num_classes: int, hidden: int = 512, drop_rate: float = 0.1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, hidden, 3, padding=1)
        self.bn = BatchNorm(hidden)
        self.out = nn.Conv2d(hidden, num_classes, 1, bias=False)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = F.relu(self.bn(self.conv(x)))
        if self.training:
            h = dropout(h, self.drop_rate, generator, channels=True)
        return self.out(h)


@torch.no_grad()
def init_torch_default(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default initialisation, drawn from ``generator``.

    Conv weights kaiming_uniform(a=sqrt(5)), i.e. U(+-1/sqrt(fan_in)); conv
    biases U(+-1/sqrt(fan_in)); BatchNorm scale 1, shift 0, running mean 0,
    running variance 1. The JAX package draws from the same distributions.
    """
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
