"""EfficientNet-B3 encoder U-Net (the factory's ``efficient_unet``).

Counterpart of ``fedicra_tpu/models/efficientunet.py``:

- the EfficientNet-B3 encoder: the B0 stage table scaled by width 1.2 and
  depth 1.4, MBConv blocks with squeeze-excitation (ratio 0.25 of the
  block's input), swish, depthwise convs as ``groups=C``, BatchNorm eps
  1e-3 and torch momentum 0.01 (flax 0.99), drop-connect on the residual
  blocks at rate ``0.2 * block_idx / total_blocks``; features tapped after
  the stem and stages 2, 3, 5 and 7 (channels 40, 32, 48, 136, 384);
- the smp U-Net decoder: nearest 2x upsampling, skip concat, (Conv3x3 -> BN
  -> ReLU) x 2 with optional SCSE attention, channels (256, 128, 64, 32, 16),
  and a 1x1 classifier.

The stride-2 convolutions pad as flax's ``padding="SAME"`` does, which is
asymmetric at even sizes: (0, 1) for k = 3, (1, 2) for k = 5.

Under AMP the 1x1 convs (expand, SE, project), the decoder's convs and the
classifier follow the compute dtype, as JAX's ``Conv`` wrappers do; the
stem and the depthwise convs are bare convs in JAX and stay fp32 here.

Drop-connect draws each residual block's per-sample mask from the forward's
generator (``draw_drop_connect``) apart from its application
(``drop_connect``), so a caller can feed draws of its own.

``load_pretrained_encoder`` maps an efficientnet-pytorch B3 ``state_dict``
(``--encoder_weights``, a local ``.pth`` the user supplies) onto the
encoder. Nothing is downloaded: ``pretrained='imagenet'`` raises.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.data_axis import batch_draw
from .blocks import BatchNorm, conv

# B0 stage table: (num_repeat, kernel, stride, expand, out_channels)
B0_STAGES = (
    (1, 3, 1, 1, 16),
    (2, 3, 2, 6, 24),
    (2, 5, 2, 6, 40),
    (3, 3, 2, 6, 80),
    (3, 5, 1, 6, 112),
    (4, 5, 2, 6, 192),
    (1, 3, 1, 6, 320),
)
WIDTH, DEPTH = 1.2, 1.4  # B3
TAP_AFTER_STAGE = (1, 2, 4, 6)  # smp's taps at /4, /8, /16, /32
ENCODER_BN = dict(eps=1e-3, momentum=0.01)


def round_filters(f: float, width: float = WIDTH, divisor: int = 8) -> int:
    f *= width
    new_f = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * f:
        new_f += divisor
    return int(new_f)


def round_repeats(r: int, depth: float = DEPTH) -> int:
    return int(math.ceil(depth * r))


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding (low, high) of one dimension: out = ceil(size /
    stride), the extra pixel of an odd total at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` (built with ``padding=0``) on x padded as "SAME"."""
    k, s = layer.kernel_size[0], layer.stride[0]
    top, bottom = same_padding(x.shape[-2], k, s)
    left, right = same_padding(x.shape[-1], k, s)
    return layer(F.pad(x, (left, right, top, bottom)))


def draw_drop_connect(x: torch.Tensor, keep: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Which samples keep the block's residual branch, (B, 1, 1, 1) bool."""
    u = batch_draw(lambda shape: torch.rand(shape, generator=generator, device=x.device),
                   (x.shape[0], 1, 1, 1))
    return u < keep


def drop_connect(h: torch.Tensor, keep_mask: torch.Tensor, keep: float) -> torch.Tensor:
    return h * keep_mask / keep


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.reduce = conv(channels, se_channels, kernel_size=1)
        self.expand = conv(se_channels, channels, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.expand(F.silu(self.reduce(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Expand 1x1 -> depthwise kxk -> SE -> project 1x1, each conv with BN;
    a residual (with drop-connect) when the shape is kept."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, expand: int,
                 se_ratio: float = 0.25, drop_rate: float = 0.0):
        super().__init__()
        mid = in_ch * expand
        self.expand = expand
        if expand != 1:
            self.expand_conv = conv(in_ch, mid, kernel_size=1, bias=False)
            self.bn0 = BatchNorm(mid, **ENCODER_BN)
        self.dwconv = nn.Conv2d(mid, mid, kernel, stride=stride, groups=mid, bias=False)
        self.bn1 = BatchNorm(mid, **ENCODER_BN)
        self.se = SqueezeExcite(mid, max(1, int(in_ch * se_ratio))) if se_ratio > 0 else None
        self.project_conv = conv(mid, out_ch, kernel_size=1, bias=False)
        self.bn2 = BatchNorm(out_ch, **ENCODER_BN)
        self.residual = stride == 1 and in_ch == out_ch
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x
        if self.expand != 1:
            h = F.silu(self.bn0(self.expand_conv(h)))
        h = F.silu(self.bn1(conv_same(self.dwconv, h)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn2(self.project_conv(h))
        if self.residual:
            if keep_mask is not None:
                h = drop_connect(h, keep_mask, 1.0 - self.drop_rate)
            h = h + x
        return h


class EfficientNetEncoder(nn.Module):
    """Returns the pyramid [x, /2, /4, /8, /16, /32], NCHW."""

    def __init__(self, in_chns: int, width: float = WIDTH, depth: float = DEPTH,
                 drop_connect: float = 0.2):
        super().__init__()
        stem_ch = round_filters(32, width)
        self.stem_conv = nn.Conv2d(in_chns, stem_ch, 3, stride=2, bias=False)
        self.stem_bn = BatchNorm(stem_ch, **ENCODER_BN)
        total = sum(round_repeats(r, depth) for r, *_ in B0_STAGES)
        self.blocks: List[str] = []
        self.taps: List[str] = []  # the blocks whose outputs are tapped
        self.out_channels = [stem_ch]
        in_ch, idx = stem_ch, 0
        for si, (r, k, s, e, c) in enumerate(B0_STAGES):
            out_ch = round_filters(c, width)
            for bi in range(round_repeats(r, depth)):
                name = f"block{si}_{bi}"
                setattr(self, name, MBConv(in_ch, out_ch, k, s if bi == 0 else 1, e,
                                           drop_rate=drop_connect * idx / total))
                self.blocks.append(name)
                in_ch, idx = out_ch, idx + 1
            if si in TAP_AFTER_STAGE:
                self.taps.append(name)
                self.out_channels.append(out_ch)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        feats = [x]
        h = F.silu(self.stem_bn(conv_same(self.stem_conv, x)))
        feats.append(h)
        for name in self.blocks:
            block = getattr(self, name)
            mask = None
            if self.training and block.residual and block.drop_rate > 0:
                mask = draw_drop_connect(h, 1.0 - block.drop_rate, generator)
            h = block(h, mask)
            if name in self.taps:
                feats.append(h)
        return feats


class SCSE(nn.Module):
    """Concurrent spatial and channel squeeze-excitation."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        mid = max(1, channels // reduction)
        self.c_reduce = conv(channels, mid, kernel_size=1)
        self.c_expand = conv(mid, channels, kernel_size=1)
        self.s_conv = conv(channels, 1, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.c_expand(F.relu(self.c_reduce(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s) + x * torch.sigmoid(self.s_conv(x))


class DecoderBlock(nn.Module):
    """Nearest 2x upsample, skip concat, (Conv3x3 -> BN -> ReLU) x 2."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, attention: Optional[str] = None):
        super().__init__()
        c = in_ch + skip_ch
        self.attention1 = SCSE(c) if attention == "scse" and skip_ch else None
        self.conv1 = conv(c, out_ch)
        self.bn1 = BatchNorm(out_ch)
        self.conv2 = conv(out_ch, out_ch)
        self.bn2 = BatchNorm(out_ch)
        self.attention2 = SCSE(out_ch) if attention == "scse" else None

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
            if self.attention1 is not None:
                x = self.attention1(x)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        if self.attention2 is not None:
            x = self.attention2(x)
        return x


class EffiUNet(nn.Module):
    """``forward(x, emb_idx, generator)`` returns ``logits`` and the encoder's
    ``features`` from /32 to /2, NHWC; ``emb_idx`` is ignored, ``generator``
    feeds drop-connect in train mode."""

    def __init__(
        self,
        in_chns: int,
        num_classes: int,
        decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
        attention: Optional[str] = None,
        pretrained: Optional[str] = None,
    ):
        super().__init__()
        if pretrained:
            raise NotImplementedError(
                "pretrained EfficientNet weights are not downloaded; build the "
                "model, then load_pretrained_encoder(model, '<efficientnet-b3.pth>') "
                "with a locally supplied checkpoint (--encoder_weights)"
            )
        self.encoder = EfficientNetEncoder(in_chns)
        enc = self.encoder.out_channels  # [/2, /4, /8, /16, /32]
        skips = enc[::-1][1:]
        in_ch = enc[-1]
        self.num_blocks = len(decoder_channels)
        for i, ch in enumerate(decoder_channels):
            skip = skips[i] if i < len(skips) else 0
            setattr(self, f"dec{i}", DecoderBlock(in_ch, skip, ch, attention))
            in_ch = ch
        self.classifier = conv(in_ch, num_classes, kernel_size=1)

    def forward(self, x: torch.Tensor, emb_idx=None, generator: Optional[torch.Generator] = None):
        feats = self.encoder(x.permute(0, 3, 1, 2).contiguous(), generator)
        feats = feats[1:][::-1]  # [/32, /16, /8, /4, /2]
        h, skips = feats[0], feats[1:]
        for i in range(self.num_blocks):
            h = getattr(self, f"dec{i}")(h, skips[i] if i < len(skips) else None)
        logits = self.classifier(h)
        return {"logits": logits.permute(0, 2, 3, 1),
                "features": [f.permute(0, 2, 3, 1) for f in feats]}


def b3_block_layout() -> List[Tuple[str, int]]:
    """(port block name, expand) in the order efficientnet-pytorch flattens
    its ``_blocks`` ModuleList."""
    return [(f"block{si}_{bi}", e) for si, (r, _k, _s, e, _c) in enumerate(B0_STAGES)
            for bi in range(round_repeats(r))]


def convert_torch_encoder_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """An efficientnet-pytorch B3 ``state_dict`` (tensors or arrays) -> the
    port's encoder ``state_dict`` (names relative to ``model.encoder``).

    Raises KeyError when an expected key is missing: a checkpoint of another
    architecture fails loudly, not silently. The head (``_conv_head``,
    ``_bn1``, ``_fc``) is not part of the encoder and is ignored.
    """

    def arr(key: str) -> torch.Tensor:
        return torch.as_tensor(state_dict[key]).detach().to("cpu", torch.float32).clone()

    out: Dict[str, torch.Tensor] = {}

    def bn(dst: str, src: str) -> None:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = arr(f"{src}.{leaf}")

    out["stem_conv.weight"] = arr("_conv_stem.weight")
    bn("stem_bn", "_bn0")
    for g, (name, expand) in enumerate(b3_block_layout()):
        src = f"_blocks.{g}"
        if expand != 1:
            out[f"{name}.expand_conv.weight"] = arr(f"{src}._expand_conv.weight")
            bn(f"{name}.bn0", f"{src}._bn0")
        out[f"{name}.dwconv.weight"] = arr(f"{src}._depthwise_conv.weight")
        bn(f"{name}.bn1", f"{src}._bn1")
        for part in ("reduce", "expand"):
            for leaf in ("weight", "bias"):
                out[f"{name}.se.{part}.{leaf}"] = arr(f"{src}._se_{part}.{leaf}")
        out[f"{name}.project_conv.weight"] = arr(f"{src}._project_conv.weight")
        bn(f"{name}.bn2", f"{src}._bn2")
    return out


def load_pretrained_encoder(model: EffiUNet, weights) -> EffiUNet:
    """Load efficientnet-pytorch B3 weights into ``model.encoder`` in place.

    ``weights``: a ``.pth`` path (read with ``torch.load(weights_only=True)``)
    or an already loaded ``state_dict``. Raises KeyError on a missing key and
    ValueError on a leaf of another shape (a wrong checkpoint variant).
    """
    if isinstance(weights, (str, bytes)):
        weights = torch.load(weights, map_location="cpu", weights_only=True)
    converted = convert_torch_encoder_state_dict(weights)
    own = model.encoder.state_dict()
    if converted.keys() != own.keys():
        raise KeyError(f"encoder leaves not in the checkpoint: {sorted(set(own) - set(converted))}")
    for k, v in converted.items():
        if v.shape != own[k].shape:
            raise ValueError(f"converted encoder leaf {k} has shape {tuple(v.shape)}, expected "
                             f"{tuple(own[k].shape)}: wrong checkpoint variant?")
    model.encoder.load_state_dict(converted)
    return model
