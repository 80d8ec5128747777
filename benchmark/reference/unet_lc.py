"""The FedICRA model, ``unet_lc_multihead``, written out in plain PyTorch.

The reference the benchmark holds the port's round against. It follows the
FedICRA paper (arXiv:2304.05635) and the reference code's ``UNet_LC_MultiHead``:

- encoder: a conv block (3x3 conv, BatchNorm, LeakyReLU 0.01, dropout,
  3x3 conv, BatchNorm, LeakyReLU) at the first of the five ``features``,
  then four stages of 2x2 max-pool and a conv block at the others, each
  block with its own ``dropout`` rate;
- personalised channel selection (PCS) on the bottleneck: a client one-hot
  through two 1x1 convs, joined to the average and the maximum of the
  features, a shared two-layer 1x1 bottleneck (f / 16), a sigmoid heatmap
  h, and x * h + x;
- decoder: four up stages (1x1 conv, align-corners bilinear upsampling to
  the skip, concatenation [skip, up], a conv block without dropout), a 3x3
  out conv, and three deep-supervision heads on the 2nd, 3rd and 4th up
  stage (3x3 conv to ``dsn_hidden``, BatchNorm, ReLU, channel dropout
  ``dsn_dropout``, 1x1 conv without bias).

Every width and rate comes from a configuration's ``widths`` block (the
published model: features 16 / 32 / 64 / 128 / 256, dropout 0.05 / 0.1 /
0.2 / 0.3 / 0.5, one PCS stage, 3 heads of 512, head dropout 0.1).

Parameters are one flat dict keyed by dotted names; ``param_specs`` lists
them. BatchNorm in train mode normalises by the batch's mean and biased
variance, written out here; the running statistics are not kept (no
training output reads them). Dropout draws each mask as
``empty(shape).bernoulli_(1 - p, generator=g)`` in the order the layers
run, so a generator seeded alike draws the same masks on the same device.

``round_bits=n`` rounds each convolution's operands, forward and backward,
to n mantissa bits first (10: TF32, 7: bfloat16): a control, the reference
in the precision below the one a configuration states, which the
comparison has to fail.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.01
BN_EPS = 1e-5


def _conv_block_specs(prefix: str, cin: int, cout: int) -> List[tuple]:
    out = []
    for half, c_in in (("conv1", cin), ("conv2", cout)):
        out += [
            (f"{prefix}.{half}.conv.weight", (cout, c_in, 3, 3), c_in * 9),
            (f"{prefix}.{half}.conv.bias", (cout,), c_in * 9),
            (f"{prefix}.{half}.norm.weight", (cout,), None),
            (f"{prefix}.{half}.norm.bias", (cout,), None),
        ]
    return out


def check_widths(widths: dict) -> None:
    """The widths this reference can build: five feature widths, one PCS
    stage, at most three deep-supervision heads."""
    if len(widths["features"]) != 5 or len(widths["dropout"]) != 5:
        raise ValueError(f"five feature widths and dropout rates, got {widths}")
    if widths["pcs_stages"] != 1 or not 0 <= widths["dsn_heads"] <= 3:
        raise ValueError(f"one PCS stage and up to three heads, got {widths}")


def head_sources(widths: dict) -> List[int]:
    """The up stage (index into the up stages' outputs, 1 to 3) each
    deep-supervision head reads."""
    return list(range(1, widths["dsn_heads"] + 1))


def encoder_specs(in_chns: int, f) -> List[tuple]:
    """The five encoder stages' parameters."""
    specs = _conv_block_specs("encoder.in_conv", in_chns, f[0])
    for i in range(1, 5):
        specs += _conv_block_specs(f"encoder.down{i}.block", f[i - 1], f[i])
    return specs


def decoder_specs(num_classes: int, f) -> List[tuple]:
    """The four up stages' parameters and the out conv's."""
    specs = []
    for i, (low, skip) in enumerate(((f[4], f[3]), (f[3], f[2]), (f[2], f[1]), (f[1], f[0])), 1):
        specs += [
            (f"decoder.up{i}.conv1x1.weight", (skip, low, 1, 1), low),
            (f"decoder.up{i}.conv1x1.bias", (skip,), low),
        ]
        specs += _conv_block_specs(f"decoder.up{i}.block", 2 * skip, skip)
    return specs + [
        ("decoder.out_conv.weight", (num_classes, f[0], 3, 3), f[0] * 9),
        ("decoder.out_conv.bias", (num_classes,), f[0] * 9),
    ]


def param_specs(in_chns: int, num_classes: int, num_clients: int,
                widths: dict) -> List[Tuple[str, tuple, Optional[int]]]:
    """(name, shape, fan_in) of every parameter; fan_in None marks a
    BatchNorm scale or shift."""
    check_widths(widths)
    f, hidden = widths["features"], widths["dsn_hidden"]
    fd, hid = f[4], max(f[4] // 16, 1)
    specs = encoder_specs(in_chns, f) + [
        ("encoder.pcs0.fc1_a.weight", (fd, num_clients, 1, 1), num_clients),
        ("encoder.pcs0.fc1_b.weight", (fd, fd, 1, 1), fd),
        ("encoder.pcs0.fc2_a.weight", (hid, 2 * fd, 1, 1), 2 * fd),
        ("encoder.pcs0.fc2_b.weight", (fd, hid, 1, 1), hid),
    ] + decoder_specs(num_classes, f)
    for i in head_sources(widths):
        src = f[3 - i]  # the channels of up stage i's output
        specs += [
            (f"decoder.dsn_head{i}.conv.weight", (hidden, src, 3, 3), src * 9),
            (f"decoder.dsn_head{i}.conv.bias", (hidden,), src * 9),
            (f"decoder.dsn_head{i}.bn.weight", (hidden,), None),
            (f"decoder.dsn_head{i}.bn.bias", (hidden,), None),
            (f"decoder.dsn_head{i}.out.weight", (num_classes, hidden, 1, 1), hidden),
        ]
    return specs


def _block_convs(prefix: str, c_in: int, c_out: int, pixels: int) -> List[tuple]:
    return [(f"{prefix}.conv1.conv", c_in, c_out, 3, pixels, 1),
            (f"{prefix}.conv2.conv", c_out, c_out, 3, pixels, 1)]


def encoder_convs(in_chns: int, f, img: int) -> List[tuple]:
    """The encoder's convolutions of one ``img``^2 image: (name, C_in,
    C_out, kernel, output pixels, groups)."""
    out = _block_convs("encoder.in_conv", in_chns, f[0], img * img)
    for i in range(1, 5):
        out += _block_convs(f"encoder.down{i}.block", f[i - 1], f[i], (img >> i) ** 2)
    return out


def decoder_convs(num_classes: int, f, img: int) -> List[tuple]:
    """The up stages' and the out conv's convolutions of one ``img``^2 image."""
    out = []
    for i in range(1, 5):
        low, skip = f[5 - i], f[4 - i]
        out.append((f"decoder.up{i}.conv1x1", low, skip, 1, (img >> (5 - i)) ** 2, 1))
        out += _block_convs(f"decoder.up{i}.block", 2 * skip, skip, (img >> (4 - i)) ** 2)
    return out + [("decoder.out_conv", f[0], num_classes, 3, img * img, 1)]


def round_mantissa(t: torch.Tensor, keep: int) -> torch.Tensor:
    """``t`` (float32) rounded to nearest-even at ``keep`` mantissa bits."""
    drop = 23 - keep
    bits = t.contiguous().view(torch.int32)
    bits = (bits + ((1 << (drop - 1)) - 1) + ((bits >> drop) & 1)) & ~((1 << drop) - 1)
    return bits.view(torch.float32)


class _RoundedConv(torch.autograd.Function):
    """A 'same' stride-1 convolution whose three products (forward, input
    gradient, weight gradient) each take operands rounded to ``keep``
    mantissa bits and sum in float32, as the card's TF32 convolutions do."""

    @staticmethod
    def forward(ctx, x, w, b, keep):
        x, w = round_mantissa(x, keep), round_mantissa(w, keep)
        ctx.save_for_backward(x, w)
        ctx.has_bias, ctx.keep = b is not None, keep
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = round_mantissa(g, ctx.keep)
        pad = w.shape[-1] // 2
        dx = torch.nn.grad.conv2d_input(x.shape, w, g, padding=pad)
        dw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=pad)
        return dx, dw, g.sum(dim=(0, 2, 3)) if ctx.has_bias else None, None


class UNetOps:
    """The U-Net family's layers over a flat parameter dict, NCHW."""

    def __init__(self, round_bits: Optional[int] = None):
        if round_bits is not None and not 1 <= round_bits < 23:
            raise ValueError(f"round_bits {round_bits!r}")
        self.round_bits = round_bits

    def conv(self, p, name, x, bias=True):
        w, b = p[f"{name}.weight"], p[f"{name}.bias"] if bias else None
        if self.round_bits is not None:
            return _RoundedConv.apply(x, w, b, self.round_bits)
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    @staticmethod
    def batch_norm(p, name, x):
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        scale = p[f"{name}.weight"][None, :, None, None]
        shift = p[f"{name}.bias"][None, :, None, None]
        return (x - mean) * torch.rsqrt(var + BN_EPS) * scale + shift

    @staticmethod
    def dropout(x, rate, generator, channels=False):
        if rate == 0.0:
            return x
        shape = x.shape[:2] + (1, 1) if channels else x.shape
        keep = torch.empty(shape, device=x.device, dtype=x.dtype).bernoulli_(1.0 - rate,
                                                                            generator=generator)
        return x * keep / (1.0 - rate)

    def conv_block(self, p, name, x, rate, generator):
        x = F.leaky_relu(self.batch_norm(p, f"{name}.conv1.norm", self.conv(p, f"{name}.conv1.conv", x)),
                         LRELU_SLOPE)
        x = self.dropout(x, rate, generator)
        return F.leaky_relu(self.batch_norm(p, f"{name}.conv2.norm", self.conv(p, f"{name}.conv2.conv", x)),
                            LRELU_SLOPE)

    def encoder(self, p, x, rates, generator):
        """The five stages' outputs: a conv block, then four of 2x2 max-pool
        and a conv block."""
        skips = [self.conv_block(p, "encoder.in_conv", x, rates[0], generator)]
        for i in range(1, 5):
            skips.append(self.conv_block(p, f"encoder.down{i}.block", F.max_pool2d(skips[-1], 2),
                                         rates[i], generator))
        return skips

    def up(self, p, skips, generator):
        """The four up stages' outputs, from the encoder's."""
        x, ups = skips[-1], []
        for i in range(1, 5):
            skip = skips[4 - i]
            low = F.interpolate(self.conv(p, f"decoder.up{i}.conv1x1", x), size=skip.shape[-2:],
                                mode="bilinear", align_corners=True)
            x = self.conv_block(p, f"decoder.up{i}.block", torch.cat([skip, low], dim=1), 0.0,
                                generator)
            ups.append(x)
        return ups


class UNetLCMultiHead(UNetOps):
    """The forward pass over a flat parameter dict, NHWC in and out."""

    def __init__(self, num_clients: int, widths: dict, round_bits: Optional[int] = None):
        super().__init__(round_bits)
        check_widths(widths)
        self.num_clients = num_clients
        self.widths = widths

    def pcs(self, p, x, client):
        onehot = F.one_hot(client, self.num_clients).to(x.dtype)[:, :, None, None]
        e = self.conv(p, "encoder.pcs0.fc1_b", F.relu(self.conv(p, "encoder.pcs0.fc1_a", onehot, False)),
                      False)

        def shared(pooled):
            h = F.relu(self.conv(p, "encoder.pcs0.fc2_a", torch.cat([pooled, e], dim=1), False))
            return self.conv(p, "encoder.pcs0.fc2_b", h, False)

        heat = torch.sigmoid(shared(x.mean(dim=(2, 3), keepdim=True))
                             + shared(x.amax(dim=(2, 3), keepdim=True)))
        return x * heat + x, heat

    def __call__(self, p: Dict[str, torch.Tensor], images: torch.Tensor, client: torch.Tensor,
                 generator: Optional[torch.Generator]):
        """images [B, H, W, C_in]; client [B] long. Returns (logits NHWC,
        [aux1, ...] NHWC, one a head, heatmap [B, 1, 1, features[4]])."""
        rates = self.widths["dropout"]
        skips = self.encoder(p, images.permute(0, 3, 1, 2), rates, generator)
        skips[-1], heat = self.pcs(p, skips[-1], client)
        ups = self.up(p, skips, generator)
        logits = self.conv(p, "decoder.out_conv", ups[-1])
        aux = []
        for i in head_sources(self.widths):
            h = F.relu(self.batch_norm(p, f"decoder.dsn_head{i}.bn",
                                       self.conv(p, f"decoder.dsn_head{i}.conv", ups[i])))
            h = self.dropout(h, self.widths["dsn_dropout"], generator, channels=True)
            aux.append(self.conv(p, f"decoder.dsn_head{i}.out", h, False))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return nhwc(logits), [nhwc(a) for a in aux], nhwc(heat)
