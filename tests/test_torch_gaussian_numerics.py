"""The arithmetic of the Gaussian-filter CUDA kernel, emulated on the CPU.

``fedicra_torch/csrc/gaussian_filter.cu`` forms each exponent on the tensor
cores in TF32 and sums exp2(exponent) times v in fp32. This file repeats its
numerics in PyTorch, operand by operand, and holds the result to a float64
direct sum and to JAX's plain reference of the Pallas kernel
(``_gaussian_filter_xla``):

- features centred on the mean of the block's 256 query rows, augmented to
  depth 8: A_i = [L g_i, -L/2 |g_i|^2, 1, 0..], B_j = [g_j, 1, -L/2 |g_j|^2, 0..]
  with g = f - mean and L = log2(e), so A_i.B_j = -L/2 |f_i - f_j|^2;
- each operand split into hi = rna(x) and lo = rna(x - hi) in TF32 (round
  to nearest by masking the low 13 bits of the int32 view), L g carrying the
  rounding of its product into lo (as the kernel's FMA does) and the norms
  summed in float64;
- the exponent taken as hi.hi + hi.lo + lo.hi, three products, each sum
  rounded toward zero in fp32 as the tensor cores' accumulate may be;
- the weights exp2 of that in fp32, summed with v by fp32 FMAs in the
  order of a block that takes every column: each of four lanes takes
  columns 8k + 2t and 8k + 2t + 1 of every 8, and the lanes add pairwise at
  the end (images the kernel splits into column shares add the shares'
  sums in share order instead);
- columns past N staged as f = 0, v = 0.

Tolerance rtol 1e-4 on features whose |f|^2 reaches ~900 (white pixels at
rgb/15), the kernel tests' tolerance. A single TF32 exponent misses it by
far, which is why the kernel splits; and value sums on the tensor cores
with P and v rounded to TF32 once miss it where few columns carry a sum,
which is why they stay in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.ops.gaussian_filter_cuda import bilateral_features
from fedicra_tpu.ops.pallas_kernels import _gaussian_filter_xla
from torch_card import smooth_images

LOG2E = float(np.float32(1.4426950408889634))  # the kernel's fp32 constant
ROWS_PER_BLOCK = 256  # query rows per block (one mean each)
TILE = 256            # columns staged at a time; N is padded to it


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def rz32(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def split_half_norm(g: torch.Tensor):
    """-L/2 |g|^2 summed in float64, as hi and lo (..., 1)."""
    x = -0.5 * LOG2E * (g.double() ** 2).sum(-1, keepdim=True)
    hi = tf32_rna(x.float())
    return hi, tf32_rna((x - hi.double()).float())


def operands(g: torch.Tensor, query: bool):
    """(..., 8) hi and lo operands of depth 8 from centred features g (..., D)."""
    n_hi, n_lo = split_half_norm(g)
    one, zero = torch.ones_like(n_hi), torch.zeros_like(n_hi)
    if query:
        prod = LOG2E * g  # fp32 product; its rounding error joins lo, as an FMA gives it
        err = (LOG2E * g.double() - prod.double()).float()
        g_hi = tf32_rna(prod)
        g_lo = tf32_rna((prod - g_hi) + err)
        hi, lo = torch.cat([g_hi, n_hi, one], -1), torch.cat([g_lo, n_lo, zero], -1)
    else:
        g_hi, g_lo = split(g)
        hi, lo = torch.cat([g_hi, one, n_hi], -1), torch.cat([g_lo, zero, n_lo], -1)
    pad = (0, 8 - hi.shape[-1])
    return torch.nn.functional.pad(hi, pad), torch.nn.functional.pad(lo, pad)


def lane_sums(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_j p[:, j] v[j] as the kernel adds it: lane t of 4 takes columns
    8k + 2t, then 8k + 2t + 1, of every 8 by fp32 FMAs, in column order; the
    lanes then add as (t0 + t1) + (t2 + t3)."""
    rows, n = p.shape
    acc = torch.zeros(rows, 4, v.shape[1])
    lanes = 2 * torch.arange(4)
    for k in range(0, n, 8):
        for e in (0, 1):
            cols = k + lanes + e
            acc = (acc.double() + p[:, cols].double()[..., None] * v[cols].double()).float()
    return (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])


def emulate_kernel(f: torch.Tensor, v: torch.Tensor, *, split_exponent: bool = True,
                   centre: bool = True, tf32_values: bool = False) -> torch.Tensor:
    """The kernel's output for features f (N, D) and values v (N, C), float32.

    ``split_exponent=False`` takes the exponent as one TF32 product;
    ``tf32_values=True`` sums P.V as one TF32 product of P and v rounded to
    nearest (the alternative the kernel does not take)."""
    n, c = v.shape
    n_pad = -(-n // TILE) * TILE
    f_pad = torch.zeros(n_pad, f.shape[1]).index_copy_(0, torch.arange(n), f)
    v_pad = torch.zeros(n_pad, c).index_copy_(0, torch.arange(n), v)
    out = torch.empty(n, c)
    for r0 in range(0, n, ROWS_PER_BLOCK):
        rows = f[r0:r0 + ROWS_PER_BLOCK]
        mean = rows.mean(0) if centre else torch.zeros(f.shape[1])
        a_hi, a_lo = (x.double() for x in operands(rows - mean, query=True))
        b_hi, b_lo = (x.double() for x in operands(f_pad - mean, query=False))
        if split_exponent:
            s = rz32(a_hi @ b_hi.T)
            s = rz32(s.double() + a_hi @ b_lo.T)
            s = rz32(s.double() + a_lo @ b_hi.T)
        else:
            s = rz32(a_hi @ b_hi.T)
        p = torch.exp2(s)
        if tf32_values:
            out[r0:r0 + ROWS_PER_BLOCK] = rz32(tf32_rna(p).double() @ tf32_rna(v_pad).double())
        else:
            out[r0:r0 + ROWS_PER_BLOCK] = lane_sums(p, v_pad)
    return out


def direct_float64(f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    d2 = torch.cdist(f.double(), f.double()) ** 2
    return torch.exp(-0.5 * d2) @ v.double()


def image_features(seed: int, h: int, w: int, white: bool) -> torch.Tensor:
    """Dense-CRF features [x/50, y/50, rgb/15] of a smooth image scaled to
    0..255; with a white square, where |f|^2 reaches ~900."""
    img = smooth_images(np.random.default_rng(seed), 1, h, w)[0]
    if white:
        img[h // 4:h // 2 + 3, w // 3:w // 3 + w // 2] = 1.0
    return bilateral_features(torch.as_tensor(img) * 255.0, 15.0, 50.0)


def xla_reference(f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.array(_gaussian_filter_xla(jnp.asarray(f.numpy()),
                                                           jnp.asarray(v.numpy()))))


CASES = [  # (seed, h, w, white image, value channels)
    (0, 37, 41, True, 3),    # N = 1517: ragged against the 8-column slice and the tile
    (1, 24, 50, True, 1),
    (2, 33, 33, False, 4),
]


@pytest.mark.parametrize("seed, h, w, white, c", CASES)
def test_emulated_kernel_holds_rtol_1e4(seed, h, w, white, c):
    f = image_features(seed, h, w, white)
    v = torch.as_tensor(np.random.default_rng(seed).uniform(size=(h * w, c)), dtype=torch.float32)
    if white:
        assert (f * f).sum(-1).max() > 850.0
    got = emulate_kernel(f, v)
    want = direct_float64(f, v)
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-6 * want.abs().max().item())
    xla = xla_reference(f, v)
    torch.testing.assert_close(got, xla, rtol=1e-4, atol=1e-6 * xla.abs().max().item())


def test_emulated_kernel_on_spread_features_with_few_columns():
    """Few columns, so few terms average the roundings: N = 37 and 1, the
    kernel tests' smallest shapes, whose values are not on the image grid."""
    rng = np.random.default_rng(5)
    for n, d in ((37, 3), (1, 4), (13, 5)):
        f = torch.as_tensor(rng.uniform(0, 3, size=(n, d)), dtype=torch.float32)
        v = torch.as_tensor(rng.uniform(size=(n, 2)), dtype=torch.float32)
        torch.testing.assert_close(emulate_kernel(f, v).double(), direct_float64(f, v),
                                   rtol=1e-4, atol=1e-6)


def test_single_tf32_exponent_misses_the_tolerance():
    """One TF32 product for the exponent (no split, no centring) errs by
    ~1e-2 relative at |f|^2 ~ 900: the reason the kernel takes three."""
    f = image_features(0, 37, 41, True)
    v = torch.as_tensor(np.random.default_rng(0).uniform(size=(len(f), 3)), dtype=torch.float32)
    want = direct_float64(f, v)
    rel = lambda got: ((got.double() - want).abs() / want.abs()).max().item()  # noqa: E731
    single = rel(emulate_kernel(f, v, split_exponent=False, centre=False))
    assert single > 1e-3
    assert rel(emulate_kernel(f, v)) < 1e-4 < single


def test_tf32_value_sums_miss_the_tolerance_with_few_columns():
    """P.V as one TF32 product of rounded P and v errs by up to 2^-11 of a
    term, which a sum over few columns does not average away: the reason
    the kernel keeps the value sums in fp32."""
    rng = np.random.default_rng(5)
    f = torch.as_tensor(rng.uniform(0, 3, size=(37, 3)), dtype=torch.float32)
    v = torch.as_tensor(rng.uniform(size=(37, 2)), dtype=torch.float32)
    want = direct_float64(f, v)
    rel = lambda got: ((got.double() - want).abs() / want.abs()).max().item()  # noqa: E731
    assert rel(emulate_kernel(f, v, tf32_values=True)) > 1e-4 > rel(emulate_kernel(f, v))


def test_translated_features_give_the_same_filter():
    """Distances do not change under translation, and the centring makes the
    operands not change either: features 300 away from the origin (|f|^2 ~
    5e5) filter as the originals do, and the padding columns, staged at
    f = 0 far from every query, weigh exactly 0 instead of NaN."""
    f = image_features(3, 19, 23, False)
    v = torch.as_tensor(np.random.default_rng(3).uniform(size=(len(f), 2)), dtype=torch.float32)
    want = direct_float64(f, v)
    got = emulate_kernel(f + 300.0, v)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-6 * want.abs().max().item())
