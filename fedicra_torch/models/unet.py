"""The FedICRA flagship model: LCEncoder + PCS + three DSN heads.

Counterpart of ``fedicra_tpu/models/unet.py`` (``LCEncoder``,
``PersonalizedChannelSelection``, ``DecoderMultiHead``, ``UNetLCMultiHead``).
The model takes and returns NHWC tensors, as the JAX model does; inside it
computes in NCHW, and its outputs are NHWC views of the NCHW results.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ConvBlock, DSNHead, DownBlock, UpBlock, conv

DEFAULT_FEATURES = (16, 32, 64, 128, 256)
DEFAULT_DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


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
        hmap = torch.sigmoid(avg_o + max_o)  # (B, C, 1, 1)
        return x * hmap + x, hmap


class LCEncoder(nn.Module):
    """Five-stage encoder with PCS on the last ``pcs_num`` stages."""

    def __init__(
        self,
        in_chns: int,
        num_clients: int,
        client_id: int = 0,
        pcs_num: int = 1,
        features: Sequence[int] = DEFAULT_FEATURES,
        dropout: Sequence[float] = DEFAULT_DROPOUT,
    ):
        super().__init__()
        f, d = features, dropout
        self.num_clients = num_clients
        self.client_id = client_id
        self.pcs_num = pcs_num
        self.in_conv = ConvBlock(in_chns, f[0], d[0])
        for i in range(1, 5):
            setattr(self, f"down{i}", DownBlock(f[i - 1], f[i], d[i]))
        for j in range(pcs_num):
            setattr(
                self, f"pcs{j}",
                PersonalizedChannelSelection(f[5 - pcs_num + j], num_clients),
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
        stages = [self.in_conv] + [getattr(self, f"down{i}") for i in range(1, 5)]
        features, heatmaps = [], []
        for i, stage in enumerate(stages):
            x = stage(x, generator)
            hmap = None
            if i >= 5 - self.pcs_num:
                x, hmap = getattr(self, f"pcs{i - (5 - self.pcs_num)}")(x, emb)
            features.append(x)
            heatmaps.append(hmap)
        return features, heatmaps


class DecoderMultiHead(nn.Module):
    """Bilinear decoder with ``num_heads`` DSN heads on de2/de3/de4."""

    def __init__(
        self,
        num_classes: int,
        num_heads: int = 3,
        features: Sequence[int] = DEFAULT_FEATURES,
        dsn_dropout: float = 0.1,
    ):
        super().__init__()
        f = features
        self.up1 = UpBlock(f[4], f[3], f[3])
        self.up2 = UpBlock(f[3], f[2], f[2])
        self.up3 = UpBlock(f[2], f[1], f[1])
        self.up4 = UpBlock(f[1], f[0], f[0])
        self.out_conv = conv(f[0], num_classes)
        self.num_heads = num_heads
        sources = (f[2], f[1], f[0])
        for i in range(num_heads):
            setattr(
                self, f"dsn_head{i + 1}",
                DSNHead(sources[i], num_classes, drop_rate=dsn_dropout),
            )

    def forward(self, feature, generator=None):
        x0, x1, x2, x3, x4 = feature
        d1 = self.up1(x4, x3, generator)
        d2 = self.up2(d1, x2, generator)
        d3 = self.up3(d2, x1, generator)
        d4 = self.up4(d3, x0, generator)
        logits = self.out_conv(d4)
        sources = (d2, d3, d4)
        aux = [
            getattr(self, f"dsn_head{i + 1}")(sources[i], generator)
            for i in range(self.num_heads)
        ]
        return {"logits": logits, "de": [d1, d2, d3, d4], "aux": aux}


class UNetLCMultiHead(nn.Module):
    """LCEncoder + DecoderMultiHead with three DSN heads.

    ``forward(x)`` takes NHWC images and returns a dict of NHWC views:
    ``logits``, ``aux`` (3 heads), ``heatmaps`` (None except at PCS
    stages, where it is (B, 1, 1, C)) and ``features``.
    """

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
        self.decoder = DecoderMultiHead(num_classes, num_heads=3, dsn_dropout=dsn_dropout)

    def forward(self, x: torch.Tensor, emb_idx=None, generator: Optional[torch.Generator] = None):
        x = x.permute(0, 3, 1, 2).contiguous()
        feature, heatmaps = self.encoder(x, emb_idx=emb_idx, generator=generator)
        out = self.decoder(feature, generator)
        return {
            "logits": _nhwc(out["logits"]),
            "aux": [_nhwc(a) for a in out["aux"]],
            "heatmaps": [None if h is None else _nhwc(h) for h in heatmaps],
            "features": [_nhwc(t) for t in feature],
        }
