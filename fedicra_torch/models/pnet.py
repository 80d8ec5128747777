"""PNet2D: a flat network of dilated 3x3 convolutions (DeepIGeoS-style).

Counterpart of ``fedicra_tpu/models/pnet.py``: five blocks of two dilated
3x3 convs (dilation 1, 2, 4, 8, 16; 64 filters), each conv followed by
BatchNorm and LeakyReLU; the five blocks' outputs concatenated and mixed by
two 1x1 convs; an output block of channel dropout, a 1x1 conv, LeakyReLU,
channel dropout and the 1x1 classifier. NHWC at the boundary, NCHW inside.

Its convolutions are bare ``nn.Conv2d``, as JAX's are bare ``nn.Conv``, so
they never read the compute dtype: under AMP the network stays fp32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import LRELU_SLOPE, BatchNorm, dropout


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class PNetBlock(nn.Module):
    """(dilated Conv3x3 -> BN -> LeakyReLU) x 2."""

    def __init__(self, in_ch: int, features: int, dilation: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, padding=dilation, dilation=dilation)
        self.in1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=dilation, dilation=dilation)
        self.in2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.in1(self.conv1(x)), LRELU_SLOPE)
        return F.leaky_relu(self.in2(self.conv2(x)), LRELU_SLOPE)


class ConcatBlock(nn.Module):
    """1x1 conv (same width) -> LeakyReLU -> 1x1 conv -> LeakyReLU."""

    def __init__(self, in_ch: int, out_features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, in_ch, 1)
        self.conv2 = nn.Conv2d(in_ch, out_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv1(x), LRELU_SLOPE)
        return F.leaky_relu(self.conv2(x), LRELU_SLOPE)


class OutPutBlock(nn.Module):
    """Dropout2d -> 1x1 conv (half width) -> LeakyReLU -> Dropout2d -> 1x1 classifier."""

    def __init__(self, in_ch: int, num_classes: int, drop_rate: float = 0.3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, in_ch // 2, 1)
        self.conv2 = nn.Conv2d(in_ch // 2, num_classes, 1)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training:
            x = dropout(x, self.drop_rate, generator, channels=True)
        x = F.leaky_relu(self.conv1(x), LRELU_SLOPE)
        if self.training:
            x = dropout(x, self.drop_rate, generator, channels=True)
        return self.conv2(x)


class PNet2D(nn.Module):
    """``forward(x, emb_idx, generator)`` returns ``logits`` and the five
    blocks' ``features``, NHWC; ``emb_idx`` is ignored."""

    def __init__(
        self,
        in_chns: int,
        num_classes: int,
        num_filters: int = 64,
        ratios: Sequence[int] = (1, 2, 4, 8, 16),
    ):
        super().__init__()
        self.num_blocks = len(ratios)
        for i, r in enumerate(ratios):
            setattr(self, f"block{i + 1}", PNetBlock(in_chns if i == 0 else num_filters, num_filters, r))
        self.catblock = ConcatBlock(num_filters * len(ratios), num_filters * 2)
        self.out = OutPutBlock(num_filters * 2, num_classes)

    def forward(self, x: torch.Tensor, emb_idx=None, generator: Optional[torch.Generator] = None):
        x = x.permute(0, 3, 1, 2).contiguous()
        feats = []
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i + 1}")(x)
            feats.append(x)
        logits = self.out(self.catblock(torch.cat(feats, dim=1)), generator)
        return {"logits": _nhwc(logits), "features": [_nhwc(f) for f in feats]}
