"""The U-Net model family, with client-personalised channel selection (PCS).

Counterpart of ``fedicra_tpu/models/unet.py``: the plain, multi-head,
deep-supervision, CCT and LC (PCS) variants. Every model takes and returns
NHWC tensors, as the JAX models do; inside it computes in NCHW, and its
outputs are NHWC views of the NCHW results. Each returns JAX's output dict
(``logits``, and as the model has them ``aux``, ``de``, ``features``,
``heatmaps``), and each takes ``emb_idx`` and ``generator``: the non-LC
models ignore ``emb_idx``; ``generator`` feeds dropout and the CCT
perturbations in train mode.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import sigmoid
from ..parallel.data_axis import batch_draw
from .blocks import ConvBlock, DSNHead, DownBlock, UpBlock, conv

DEFAULT_FEATURES = (16, 32, 64, 128, 256)
DEFAULT_DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _outputs(out: dict, feature, heatmaps=None) -> dict:
    """A decoder's NCHW dict, the encoder's features (and PCS heatmaps) -> NHWC views."""
    res = {"logits": _nhwc(out["logits"])}
    if "aux" in out:
        res["aux"] = [_nhwc(a) for a in out["aux"]]
    if "de" in out:
        res["de"] = [_nhwc(d) for d in out["de"]]
    res["features"] = [_nhwc(t) for t in feature]
    if heatmaps is not None:
        res["heatmaps"] = [None if h is None else _nhwc(h) for h in heatmaps]
    return res


class PersonalizedChannelSelection(nn.Module):
    """Client-conditioned channel attention; ``fc2`` is shared by avg and max."""

    def __init__(self, f_dim: int, num_clients: int):
        super().__init__()
        self.fc1_a = conv(num_clients, f_dim, kernel_size=1, bias=False)
        self.fc1_b = conv(f_dim, f_dim, kernel_size=1, bias=False)
        self.fc2_a = conv(2 * f_dim, max(f_dim // 16, 1), kernel_size=1, bias=False)
        self.fc2_b = conv(max(f_dim // 16, 1), f_dim, kernel_size=1, bias=False)

    def forward(self, x: torch.Tensor, emb: torch.Tensor):
        # x: (B, C, H, W); emb: (B, K) one-hot client embedding
        avg_out = x.mean(dim=(2, 3), keepdim=True)
        max_out = x.amax(dim=(2, 3), keepdim=True)
        e = self.fc1_b(F.relu(self.fc1_a(emb[:, :, None, None])))
        avg_o = self.fc2_b(F.relu(self.fc2_a(torch.cat([avg_out, e], dim=1))))
        max_o = self.fc2_b(F.relu(self.fc2_a(torch.cat([max_out, e], dim=1))))
        hmap = sigmoid(avg_o + max_o)  # (B, C, 1, 1)
        return x * hmap + x, hmap


class Encoder(nn.Module):
    """The plain five-stage encoder: a ConvBlock, then four DownBlocks."""

    def __init__(
        self,
        in_chns: int,
        features: Sequence[int] = DEFAULT_FEATURES,
        dropout: Sequence[float] = DEFAULT_DROPOUT,
    ):
        super().__init__()
        f, d = features, dropout
        self.in_conv = ConvBlock(in_chns, f[0], d[0])
        for i in range(1, 5):
            setattr(self, f"down{i}", DownBlock(f[i - 1], f[i], d[i]))

    def stages(self) -> List[nn.Module]:
        return [self.in_conv] + [getattr(self, f"down{i}") for i in range(1, 5)]

    def forward(self, x: torch.Tensor, generator=None) -> List[torch.Tensor]:
        features = []
        for stage in self.stages():
            x = stage(x, generator)
            features.append(x)
        return features


class LCEncoder(Encoder):
    """The encoder with PCS on the last ``pcs_num`` stages."""

    def __init__(
        self,
        in_chns: int,
        num_clients: int,
        client_id: int = 0,
        pcs_num: int = 1,
        features: Sequence[int] = DEFAULT_FEATURES,
        dropout: Sequence[float] = DEFAULT_DROPOUT,
    ):
        super().__init__(in_chns, features, dropout)
        self.num_clients = num_clients
        self.client_id = client_id
        self.pcs_num = pcs_num
        for j in range(pcs_num):
            setattr(
                self, f"pcs{j}",
                PersonalizedChannelSelection(features[5 - pcs_num + j], num_clients),
            )

    def _embedding(self, emb_idx, x: torch.Tensor) -> torch.Tensor:
        # Reference quirk (PARITY #2): a Python None or 0 falls back to the
        # encoder's own client id; a tensor is used as given.
        if emb_idx is None or (isinstance(emb_idx, int) and emb_idx == 0):
            emb_idx = self.client_id
        batch = x.shape[0]
        if isinstance(emb_idx, int):
            emb_idx = torch.full((batch,), emb_idx, dtype=torch.long, device=x.device)
        else:
            emb_idx = torch.as_tensor(emb_idx, device=x.device).long()
            if emb_idx.ndim == 0:
                emb_idx = emb_idx.expand(batch)
        return F.one_hot(emb_idx, self.num_clients).to(x.dtype)

    def forward(self, x: torch.Tensor, emb_idx=None, generator=None):
        emb = self._embedding(emb_idx, x)
        features, heatmaps = [], []
        for i, stage in enumerate(self.stages()):
            x = stage(x, generator)
            hmap = None
            if i >= 5 - self.pcs_num:
                x, hmap = getattr(self, f"pcs{i - (5 - self.pcs_num)}")(x, emb)
            features.append(x)
            heatmaps.append(hmap)
        return features, heatmaps


class Decoder(nn.Module):
    """Bilinear decoder with a 3x3 ``out_conv``."""

    def __init__(self, num_classes: int, features: Sequence[int] = DEFAULT_FEATURES):
        super().__init__()
        f = features
        self.up1 = UpBlock(f[4], f[3], f[3])
        self.up2 = UpBlock(f[3], f[2], f[2])
        self.up3 = UpBlock(f[2], f[1], f[1])
        self.up4 = UpBlock(f[1], f[0], f[0])
        self.out_conv = conv(f[0], num_classes)

    def _up(self, feature, generator) -> List[torch.Tensor]:
        x0, x1, x2, x3, x4 = feature
        d1 = self.up1(x4, x3, generator)
        d2 = self.up2(d1, x2, generator)
        d3 = self.up3(d2, x1, generator)
        d4 = self.up4(d3, x0, generator)
        return [d1, d2, d3, d4]

    def forward(self, feature, generator=None):
        de = self._up(feature, generator)
        return {"logits": self.out_conv(de[-1]), "de": de}


class DecoderMultiHead(Decoder):
    """The decoder with ``num_heads`` DSN heads on de2/de3/de4 (1: Decoder_Head,
    2: Decoder_MultiHead_Two, 3: the FedICRA model's Decoder_MultiHead)."""

    def __init__(
        self,
        num_classes: int,
        num_heads: int = 3,
        features: Sequence[int] = DEFAULT_FEATURES,
        dsn_dropout: float = 0.1,
    ):
        super().__init__(num_classes, features)
        self.num_heads = num_heads
        sources = (features[2], features[1], features[0])
        for i in range(num_heads):
            setattr(
                self, f"dsn_head{i + 1}",
                DSNHead(sources[i], num_classes, drop_rate=dsn_dropout),
            )

    def forward(self, feature, generator=None):
        out = super().forward(feature, generator)
        sources = out["de"][1:]
        out["aux"] = [
            getattr(self, f"dsn_head{i + 1}")(sources[i], generator)
            for i in range(self.num_heads)
        ]
        return out


def _interp_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of an NCHW tensor by JAX's integer source indices
    (torch ``F.interpolate(mode='nearest')``'s rule), gathered directly."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    rows = (torch.arange(oh, dtype=torch.float32) * (h / oh)).int().to(x.device)
    cols = (torch.arange(ow, dtype=torch.float32) * (w / ow)).int().to(x.device)
    return x[:, :, rows][:, :, :, cols]


class DecoderDS(Decoder):
    """Deep-supervision decoder: a 3x3 out conv after each up stage, the
    three coarse ones resized (nearest) to the input's size."""

    def __init__(self, num_classes: int, features: Sequence[int] = DEFAULT_FEATURES):
        super().__init__(num_classes, features)
        self.out_conv_dp3 = conv(features[3], num_classes)
        self.out_conv_dp2 = conv(features[2], num_classes)
        self.out_conv_dp1 = conv(features[1], num_classes)

    def forward(self, feature, out_hw, generator=None):
        x0, x1, x2, x3, x4 = feature
        x = self.up1(x4, x3, generator)
        dp3 = _interp_nearest(self.out_conv_dp3(x), out_hw)
        x = self.up2(x, x2, generator)
        dp2 = _interp_nearest(self.out_conv_dp2(x), out_hw)
        x = self.up3(x, x1, generator)
        dp1 = _interp_nearest(self.out_conv_dp1(x), out_hw)
        x = self.up4(x, x0, generator)
        return {"logits": self.out_conv(x), "aux": [dp1, dp2, dp3]}


# --- CCT perturbations (NCHW). Each draw is apart from its application, so
# a caller can feed draws of its own (the parity tests feed JAX's).


def draw_feature_dropout(generator: Optional[torch.Generator], device=None) -> torch.Tensor:
    """The threshold's scale, uniform in [0.7, 0.9), one for the batch."""
    u = torch.rand((), generator=generator, device=device)
    return 0.7 + 0.2 * u


def feature_dropout(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Zero the pixels whose channel-mean attention is below ``scale`` times
    the image's maximum attention."""
    attention = x.mean(dim=1, keepdim=True)  # (B, 1, H, W)
    thresh = attention.flatten(1).amax(dim=1) * scale
    return x * (attention < thresh[:, None, None, None]).to(x.dtype)


def draw_feature_noise(
    x: torch.Tensor, generator: Optional[torch.Generator], uniform_range: float = 0.3
) -> torch.Tensor:
    """Multiplicative noise, uniform in [-range, range), shaped (C, H, W):
    one draw shared by the batch."""
    u = torch.rand(x.shape[1:], generator=generator, device=x.device, dtype=x.dtype)
    return u * (2 * uniform_range) - uniform_range


def feature_noise(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return x * noise[None] + x


def draw_channel_dropout(
    x: torch.Tensor, generator: Optional[torch.Generator], p: float = 0.5
) -> torch.Tensor:
    """Which channels of each image survive, (B, C, 1, 1) bool."""
    u = batch_draw(lambda shape: torch.rand(shape, generator=generator, device=x.device),
                   x.shape[:2] + (1, 1))
    return u < 1.0 - p


def channel_dropout(x: torch.Tensor, keep: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """``F.dropout2d``: whole channels dropped, the rest scaled by 1/(1-p)."""
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class UNet(nn.Module):
    """The plain U-Net; ``dropout`` overrides the encoder's per-stage rates."""

    def __init__(self, in_chns: int, num_classes: int, dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        self.encoder = Encoder(in_chns, dropout=dropout)
        self.decoder = Decoder(num_classes)

    def forward(self, x: torch.Tensor, emb_idx=None, generator: Optional[torch.Generator] = None):
        feature = self.encoder(_nchw(x), generator)
        return _outputs(self.decoder(feature, generator), feature)


class _UNetDSN(nn.Module):
    """The plain encoder and a decoder with ``num_heads`` DSN heads."""

    num_heads = 3

    def __init__(self, in_chns: int, num_classes: int):
        super().__init__()
        self.encoder = Encoder(in_chns)
        self.decoder = DecoderMultiHead(num_classes, num_heads=self.num_heads)

    def forward(self, x: torch.Tensor, emb_idx=None, generator: Optional[torch.Generator] = None):
        feature = self.encoder(_nchw(x), generator)
        return _outputs(self.decoder(feature, generator), feature)


class UNetHead(_UNetDSN):
    """U-Net with one DSN head (on de2)."""

    num_heads = 1


class UNetMultiHead(_UNetDSN):
    """U-Net with three DSN heads (on de2, de3, de4)."""

    num_heads = 3


class UNetDS(nn.Module):
    """U-Net with deep supervision: ``aux`` are the three coarse out convs."""

    def __init__(self, in_chns: int, num_classes: int):
        super().__init__()
        self.encoder = Encoder(in_chns)
        self.decoder = DecoderDS(num_classes)

    def forward(self, x: torch.Tensor, emb_idx=None, generator: Optional[torch.Generator] = None):
        x = _nchw(x)
        feature = self.encoder(x, generator)
        return _outputs(self.decoder(feature, x.shape[-2:], generator), feature)


class UNetCCT(nn.Module):
    """U-Net with one auxiliary decoder on channel-dropped features (train
    mode; in eval mode it sees the clean features)."""

    def __init__(self, in_chns: int, num_classes: int):
        super().__init__()
        self.encoder = Encoder(in_chns)
        self.main_decoder = Decoder(num_classes)
        self.aux_decoder1 = Decoder(num_classes)

    def forward(self, x: torch.Tensor, emb_idx=None, generator: Optional[torch.Generator] = None):
        feature = self.encoder(_nchw(x), generator)
        main = self.main_decoder(feature, generator)
        aux_feature = feature
        if self.training:
            aux_feature = [channel_dropout(t, draw_channel_dropout(t, generator)) for t in feature]
        aux = self.aux_decoder1(aux_feature, generator)
        return _outputs({"logits": main["logits"], "aux": [aux["logits"]]}, feature)


class UNetCCT3H(nn.Module):
    """U-Net with two perturbed auxiliary passes (channel dropout, feature
    noise), both through ``aux_decoder1``, as in the reference.

    ``aux_decoder2`` runs on the clean features and its output is dropped,
    as in JAX: in train mode its BatchNorm statistics still move.
    """

    def __init__(self, in_chns: int, num_classes: int):
        super().__init__()
        self.encoder = Encoder(in_chns)
        self.main_decoder = Decoder(num_classes)
        self.aux_decoder1 = Decoder(num_classes)
        self.aux_decoder2 = Decoder(num_classes)

    def forward(self, x: torch.Tensor, emb_idx=None, generator: Optional[torch.Generator] = None):
        feature = self.encoder(_nchw(x), generator)
        main = self.main_decoder(feature, generator)
        f1 = f2 = feature
        if self.training:
            f1 = [channel_dropout(t, draw_channel_dropout(t, generator)) for t in feature]
            f2 = [feature_noise(t, draw_feature_noise(t, generator)) for t in feature]
        aux1 = self.aux_decoder1(f1, generator)
        aux2 = self.aux_decoder1(f2, generator)
        self.aux_decoder2(feature, generator)
        return _outputs({"logits": main["logits"], "aux": [aux1["logits"], aux2["logits"]]}, feature)


class _UNetLC(nn.Module):
    """LCEncoder + DecoderMultiHead with ``num_heads`` DSN heads.

    ``forward(x, emb_idx)`` returns NHWC views: ``logits``, ``aux``, ``de``,
    ``features`` and ``heatmaps`` (None except at PCS stages, where it is
    (B, 1, 1, C)).
    """

    num_heads = 3

    def __init__(
        self,
        in_chns: int,
        num_classes: int,
        num_clients: int,
        client_id: int = 0,
        pcs_num: int = 1,
        dropout: Sequence[float] = DEFAULT_DROPOUT,
        dsn_dropout: float = 0.1,
    ):
        super().__init__()
        self.encoder = LCEncoder(
            in_chns, num_clients, client_id=client_id, pcs_num=pcs_num, dropout=dropout
        )
        self.decoder = DecoderMultiHead(
            num_classes, num_heads=self.num_heads, dsn_dropout=dsn_dropout
        )

    def forward(self, x: torch.Tensor, emb_idx=None, generator: Optional[torch.Generator] = None):
        feature, heatmaps = self.encoder(_nchw(x), emb_idx=emb_idx, generator=generator)
        return _outputs(self.decoder(feature, generator), feature, heatmaps)


class UNetLC(_UNetLC):
    """LCEncoder + one DSN head."""

    num_heads = 1


class UNetLCMultiHead(_UNetLC):
    """The FedICRA flagship: LCEncoder + three DSN heads."""

    num_heads = 3


class UNetLCMultiHeadTwo(_UNetLC):
    """LCEncoder + two DSN heads."""

    num_heads = 2
