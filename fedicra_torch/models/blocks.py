"""Convolutional building blocks of the U-Net family (NCHW inside the model).

Counterpart of ``fedicra_tpu/models/blocks.py``. Module and parameter names
follow the flax tree so that ``fedicra_torch.convert`` maps one onto the
other by rule.

Dropout draws from an explicit ``torch.Generator`` handed down the forward
pass; ``None`` uses PyTorch's default generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.01  # torch nn.LeakyReLU default negative_slope
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


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
    keep = torch.empty(shape, device=x.device, dtype=x.dtype)
    keep.bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


class BatchNorm(nn.Module):
    """BatchNorm2d (momentum 0.1, eps 1e-5) with flax's running-variance rule.

    flax updates the running variance with the *biased* batch variance;
    ``F.batch_norm`` would fold in the unbiased one. The batch statistics
    are taken from ``F.batch_norm`` itself (momentum 1 into scratch buffers)
    and the running buffers are updated here by hand.
    """

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                training=False, eps=BN_EPS,
            )
        mean = torch.zeros_like(self.running_mean)
        var_unbiased = torch.zeros_like(self.running_var)
        out = F.batch_norm(
            x, mean, var_unbiased, self.weight, self.bias,
            training=True, momentum=1.0, eps=BN_EPS,
        )
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(
                var_unbiased, alpha=BN_MOMENTUM * (n - 1) / n
            )
        return out


def conv(in_ch: int, out_ch: int, kernel_size: int = 3, bias: bool = True) -> nn.Conv2d:
    """'SAME'-padded stride-1 convolution."""
    return nn.Conv2d(in_ch, out_ch, kernel_size, padding=kernel_size // 2, bias=bias)


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
        x_low = self.conv1x1(x_low)
        if x_low.shape[-2:] != x_skip.shape[-2:]:
            x_low = F.interpolate(
                x_low, size=x_skip.shape[-2:], mode="bilinear", align_corners=True
            )
        return self.block(torch.cat([x_skip, x_low], dim=1), generator)


class DSNHead(nn.Module):
    """Deep-supervision head: Conv3x3 -> BN -> ReLU -> Dropout2d -> Conv1x1 (no bias).

    Written plainly, without the TPU version's row tiling.
    """

    def __init__(self, in_ch: int, num_classes: int, hidden: int = 512, drop_rate: float = 0.1):
        super().__init__()
        self.conv = conv(in_ch, hidden)
        self.bn = BatchNorm(hidden)
        self.out = conv(hidden, num_classes, kernel_size=1, bias=False)
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
