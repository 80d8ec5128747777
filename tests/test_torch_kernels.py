"""The CUDA wrappers (fused gated CRF, Gaussian filter): their checks here, their
kernels on the card.

This file imports no JAX, so the tests marked ``cuda`` run on a machine with
a card and no JAX stack (the repo's conftest imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import confident_logits, smooth_images
from fedicra_torch.losses.gated_crf import gated_crf_features
from fedicra_torch.ops import gated_crf_cuda, gaussian_filter_cuda


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_wrapper_refuses_cpu_tensors_before_launching():
    gated_crf_cuda.reset_launches()
    y, f = torch.zeros(1, 3, 8, 8), torch.zeros(1, 5, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gated_crf_cuda.gated_crf_fused_cuda(y, f, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gated_crf_cuda.gated_crf_fused_cuda(y, f, 2, need_acc=False)
    assert gated_crf_cuda.launches == {"gated_crf": 0}


def test_plain_twin_is_what_cpu_tensors_get():
    rng = np.random.default_rng(1)
    y = torch.softmax(torch.tensor(rng.normal(size=(2, 3, 9, 11)), dtype=torch.float32), 1)
    f = torch.tensor(rng.uniform(size=(2, 5, 9, 11)), dtype=torch.float32)
    gated_crf_cuda.reset_launches()
    got = gated_crf_cuda.gated_crf_potts(y, f, 3)
    assert got.item() == gated_crf_cuda.gated_crf_potts_plain(y, f, 3).item()
    assert gated_crf_cuda.launches["gated_crf"] == 0


def test_plain_twin_widens_bf16_y():
    """A bf16 ``y`` on the CPU takes the twin on ``y.float()``; its gradient
    comes back bf16, the fp32 gradient rounded."""
    rng = np.random.default_rng(2)
    y = torch.softmax(torch.tensor(rng.normal(size=(2, 3, 9, 11)), dtype=torch.float32), 1)
    f = torch.tensor(rng.uniform(size=(2, 5, 9, 11)), dtype=torch.float32)
    y16 = y.to(torch.bfloat16).requires_grad_(True)
    y32 = y16.detach().float().requires_grad_(True)
    gated_crf_cuda.reset_launches()
    got, want = gated_crf_cuda.gated_crf_potts(y16, f, 3), gated_crf_cuda.gated_crf_potts(y32, f, 3)
    assert got.dtype == torch.float32 and got.item() == want.item()
    got.backward()
    want.backward()
    assert y16.grad.dtype == torch.bfloat16 and torch.equal(y16.grad, y32.grad.to(torch.bfloat16))
    assert gated_crf_cuda.launches == {"gated_crf": 0}
    loss, acc = gated_crf_cuda.gated_crf_potts_fused_plain(y16.detach(), f, 3)
    loss32, acc32 = gated_crf_cuda.gated_crf_potts_fused_plain(y32.detach(), f, 3)
    assert loss.dtype == torch.float32 and torch.equal(loss, loss32) and torch.equal(acc, acc32)


def _confident_inputs(rng, b, c, h, w):
    """Near one-hot maps over smooth class regions and the gated CRF's
    features of a smooth image, where K(q) and <y(q), acc(q)> nearly cancel."""
    image = torch.as_tensor(smooth_images(rng, b, h, w))
    f = gated_crf_features(image, 6.0, 0.1).permute(0, 3, 1, 2).contiguous()
    return confident_logits(rng, b, c, h, w), f.numpy()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b, c, nf, h, w, r, confident",
    [(2, 3, 5, 37, 70, 5, False), (1, 2, 3, 9, 33, 2, False), (3, 4, 3, 16, 16, 1, False),
     (12, 3, 5, 64, 64, 5, False), (2, 4, 5, 40, 72, 4, False), (2, 3, 5, 37, 70, 5, True),
     (12, 3, 5, 64, 64, 5, True)],
)
def test_kernel_matches_plain_twin(cuda_device, b, c, nf, h, w, r, confident):
    """Loss at rtol 1e-5 and acc at rtol 1e-4 / atol 1e-6 against the fused
    twin, including ragged tiles, every pixel within the radius of a border
    and near one-hot maps; one launch per forward and none in the backward,
    whose dL/dy is -2/(B H W) acc; the same input gives the same bits."""
    rng = np.random.default_rng(b * 100 + h)
    if confident:
        assert nf == 5  # xy + the smooth image's rgb
        logits, f = _confident_inputs(rng, b, c, h, w)
    else:
        logits, f = rng.normal(size=(b, c, h, w)), rng.uniform(size=(b, nf, h, w))
    logits = torch.tensor(logits, dtype=torch.float32, device=cuda_device)
    f = torch.tensor(f, dtype=torch.float32, device=cuda_device)
    y = torch.softmax(logits, 1).requires_grad_(True)
    want, want_acc = gated_crf_cuda.gated_crf_potts_fused_plain(y.detach(), f, r)
    gated_crf_cuda.reset_launches()
    got = gated_crf_cuda.gated_crf_potts(y, f, r)
    assert gated_crf_cuda.launches == {"gated_crf": 1}
    got.backward()
    torch.cuda.synchronize()
    assert gated_crf_cuda.launches == {"gated_crf": 1}
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    torch.testing.assert_close(got, gated_crf_cuda.gated_crf_potts_plain(y.detach(), f, r), rtol=1e-5, atol=0)
    loss, acc = gated_crf_cuda.gated_crf_fused_cuda(y.detach(), f, r)
    torch.testing.assert_close(acc, want_acc, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(y.grad, want_acc * (-2.0 / (b * h * w)), rtol=1e-4, atol=1e-6)
    # no float atomics: the same input gives the bit-identical loss and acc
    loss2, acc2 = gated_crf_cuda.gated_crf_fused_cuda(y.detach(), f, r)
    assert torch.equal(loss, got.detach()) and torch.equal(loss2, loss) and torch.equal(acc2, acc)


KERNEL_SHAPES = [
    (2, 3, 5, 37, 70, 5, False), (1, 2, 3, 9, 33, 2, False), (3, 4, 3, 16, 16, 1, False),
    (12, 3, 5, 64, 64, 5, False), (2, 4, 5, 40, 72, 4, False), (2, 3, 5, 37, 70, 5, True),
    (12, 3, 5, 64, 64, 5, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b, c, nf, h, w, r, confident", KERNEL_SHAPES)
def test_bf16_entry_equals_the_fp32_launch_on_the_widened_y(cuda_device, b, c, nf, h, w, r, confident):
    """A bf16 ``y`` (AMP) is widened as the kernel stages it: loss and acc
    equal an fp32 launch on ``y.float()`` bit for bit; dL/dy comes back bf16,
    the fp32 one rounded; one launch a forward (counted as bf16), none in
    the backward."""
    rng = np.random.default_rng(b * 100 + h + 1)
    if confident:
        logits, f = _confident_inputs(rng, b, c, h, w)
    else:
        logits, f = rng.normal(size=(b, c, h, w)), rng.uniform(size=(b, nf, h, w))
    f = torch.tensor(f, dtype=torch.float32, device=cuda_device)
    y16 = torch.softmax(torch.tensor(logits, dtype=torch.float32, device=cuda_device), 1).to(torch.bfloat16)
    loss16, acc16 = gated_crf_cuda.gated_crf_fused_cuda(y16, f, r)
    loss32, acc32 = gated_crf_cuda.gated_crf_fused_cuda(y16.float(), f, r)
    assert acc16.dtype == torch.float32 and torch.equal(loss16, loss32) and torch.equal(acc16, acc32)
    y_b = y16.clone().requires_grad_(True)
    y_f = y16.float().requires_grad_(True)
    gated_crf_cuda.reset_launches()
    got = gated_crf_cuda.gated_crf_potts(y_b, f, r)
    assert gated_crf_cuda.launches_by_dtype == {"float32": 0, "bfloat16": 1}
    got.backward()
    torch.cuda.synchronize()
    assert gated_crf_cuda.launches == {"gated_crf": 1}
    gated_crf_cuda.gated_crf_potts(y_f, f, r).backward()
    assert y_b.grad.dtype == torch.bfloat16
    assert torch.equal(y_b.grad, y_f.grad.to(torch.bfloat16))


@pytest.mark.cuda
def test_bf16_no_grad_launches_once_and_writes_no_acc(cuda_device):
    rng = np.random.default_rng(9)
    y = torch.softmax(torch.tensor(rng.normal(size=(4, 3, 64, 64)), dtype=torch.float32,
                                   device=cuda_device), 1).to(torch.bfloat16).requires_grad_(True)
    f = torch.tensor(rng.uniform(size=(4, 5, 64, 64)), dtype=torch.float32, device=cuda_device)
    with_grad = gated_crf_cuda.gated_crf_potts(y, f, 5).detach()
    torch.cuda.synchronize()
    gated_crf_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    with torch.no_grad():
        got = gated_crf_cuda.gated_crf_potts(y, f, 5)
    torch.cuda.synchronize()
    assert gated_crf_cuda.launches == {"gated_crf": 1}
    assert gated_crf_cuda.launches_by_dtype == {"float32": 0, "bfloat16": 1}
    # no (B, C, H, W) float32 acc was allocated
    assert torch.cuda.max_memory_allocated(cuda_device) - base < y.numel() * 4
    assert not got.requires_grad and torch.equal(got, with_grad)


@pytest.mark.cuda
def test_saved_acc_survives_a_second_backward(cuda_device):
    rng = np.random.default_rng(7)
    y = torch.softmax(torch.tensor(rng.normal(size=(2, 3, 37, 70)), dtype=torch.float32,
                                   device=cuda_device), 1).requires_grad_(True)
    f = torch.tensor(rng.uniform(size=(2, 5, 37, 70)), dtype=torch.float32, device=cuda_device)
    gated_crf_cuda.reset_launches()
    loss = gated_crf_cuda.gated_crf_potts(y, f, 5)
    (g1,) = torch.autograd.grad(loss, y, retain_graph=True)
    (g2,) = torch.autograd.grad(loss, y)
    torch.cuda.synchronize()
    assert torch.equal(g1, g2)
    assert gated_crf_cuda.launches == {"gated_crf": 1}


@pytest.mark.cuda
def test_no_grad_launches_once_and_writes_no_acc(cuda_device):
    rng = np.random.default_rng(8)
    y = torch.softmax(torch.tensor(rng.normal(size=(4, 3, 64, 64)), dtype=torch.float32,
                                   device=cuda_device), 1).requires_grad_(True)
    f = torch.tensor(rng.uniform(size=(4, 5, 64, 64)), dtype=torch.float32, device=cuda_device)
    with_grad = gated_crf_cuda.gated_crf_potts(y, f, 5).detach()
    torch.cuda.synchronize()
    gated_crf_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    with torch.no_grad():
        got = gated_crf_cuda.gated_crf_potts(y, f, 5)
    torch.cuda.synchronize()
    assert gated_crf_cuda.launches == {"gated_crf": 1}
    # no (B, C, H, W) acc was allocated: only the loss and the per-tile sums
    assert torch.cuda.max_memory_allocated(cuda_device) - base < y.numel() * 4
    assert not got.requires_grad and torch.equal(got, with_grad)


@pytest.mark.cuda
def test_kernel_refuses_unsupported_shapes(cuda_device):
    y = torch.zeros(1, 5, 8, 8, device=cuda_device)
    f = torch.zeros(1, 5, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="classes"):
        gated_crf_cuda.gated_crf_fused_cuda(y, f, 2)
    with pytest.raises(ValueError, match="radius"):
        gated_crf_cuda.gated_crf_fused_cuda(y[:, :3].contiguous(), f, 6)
    with pytest.raises(ValueError, match="feature channels"):
        gated_crf_cuda.gated_crf_fused_cuda(y[:, :3].contiguous(), f[:, :4].contiguous(), 2)
    with pytest.raises(ValueError, match="float32"):
        gated_crf_cuda.gated_crf_fused_cuda(y[:, :3].double().contiguous(), f.double(), 2)
    with pytest.raises(ValueError, match="feats must be float32"):
        gated_crf_cuda.gated_crf_fused_cuda(y[:, :3].contiguous(), f.to(torch.bfloat16), 2)


def test_gaussian_wrapper_refuses_cpu_tensors_before_launching():
    gaussian_filter_cuda.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        gaussian_filter_cuda.gaussian_filter_cuda(torch.zeros(1, 8, 5), torch.zeros(1, 8, 3))
    assert gaussian_filter_cuda.launches == {"gaussian_filter": 0}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b, n, d, c",
    [(2, 1000, 5, 3), (1, 37, 3, 1), (3, 513, 4, 4), (1, 2049, 5, 2), (2, 4096, 3, 3), (1, 1, 4, 1),
     (2, 301, 3, 4), (1, 1203, 4, 1), (3, 130, 5, 4), (1, 7, 5, 1)],
)
def test_gaussian_kernel_matches_plain_twin(cuda_device, b, n, d, c):
    """Value and VJP at rtol 1e-4 / atol 1e-6 on non-negative values, against
    the twin and a float64 direct sum, with N off the 8-column slice, the
    256-column tile and the 256-row block; features spread as the dense
    CRF's do, so most weights are far from 0 and 1."""
    rng = np.random.default_rng(n * 10 + d)
    f = torch.tensor(rng.uniform(0, 3, size=(b, n, d)), dtype=torch.float32, device=cuda_device)
    v = torch.tensor(rng.uniform(size=(b, n, c)), dtype=torch.float32, device=cuda_device)
    g = torch.tensor(rng.uniform(size=(b, n, c)), dtype=torch.float32, device=cuda_device)
    v_k = v.clone().requires_grad_(True)
    gaussian_filter_cuda.reset_launches()
    got = gaussian_filter_cuda.gaussian_kernel_filter(f, v_k)
    (dv,) = torch.autograd.grad(got, v_k, g)
    torch.cuda.synchronize()
    assert gaussian_filter_cuda.launches == {"gaussian_filter": 2}
    torch.testing.assert_close(got, gaussian_filter_cuda.gaussian_filter_plain(f, v), rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dv, gaussian_filter_cuda.gaussian_filter_plain(f, g), rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(got.double(), _direct_float64(f, v), rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dv.double(), _direct_float64(f, g), rtol=1e-4, atol=1e-6)
    # a fixed summation order per output: the same input gives the same bits
    assert torch.equal(gaussian_filter_cuda.gaussian_filter_cuda(f, v), got.detach())


def _direct_float64(feats: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """sum_j exp(-1/2 ||f_i - f_j||^2) v_j in float64 from direct differences."""
    f = feats.double()
    d2 = ((f[:, :, None, :] - f[:, None, :, :]) ** 2).sum(-1)
    return torch.exp(-0.5 * d2) @ values.double()


@pytest.mark.cuda
@pytest.mark.parametrize("h, w, c", [(37, 41, 3), (48, 48, 4), (23, 61, 1)])
def test_gaussian_kernel_on_white_regions_matches_float64(cuda_device, h, w, c):
    """Dense-CRF features ([x/50, y/50, rgb/15] of a smooth image scaled to
    0..255) with a white square, where |f|^2 reaches ~900 and the expanded
    exponent's terms cancel most: value at rtol 1e-4 against a float64 direct
    sum, and at rtol 1e-3 against the fp32 twin, which carries ~1e-4 of each
    exponent's rounding there; two launches, forward and VJP; same bits."""
    rng = np.random.default_rng(h * w)
    img = smooth_images(rng, 2, h, w)
    img[:, h // 4:h // 2 + 3, w // 3:w // 3 + w // 2] = 1.0
    f = gaussian_filter_cuda.bilateral_features(
        torch.as_tensor(img, device=cuda_device) * 255.0, 15.0, 50.0).contiguous()
    assert (f * f).sum(-1).max().item() > 850.0
    v = torch.tensor(rng.uniform(size=(2, h * w, c)), dtype=torch.float32, device=cuda_device)
    g = torch.tensor(rng.uniform(size=(2, h * w, c)), dtype=torch.float32, device=cuda_device)
    v_k = v.clone().requires_grad_(True)
    gaussian_filter_cuda.reset_launches()
    got = gaussian_filter_cuda.gaussian_kernel_filter(f, v_k)
    (dv,) = torch.autograd.grad(got, v_k, g)
    torch.cuda.synchronize()
    assert gaussian_filter_cuda.launches == {"gaussian_filter": 2}
    for out, vals in ((got.detach(), v), (dv, g)):
        want = _direct_float64(f, vals)
        torch.testing.assert_close(out.double(), want, rtol=1e-4, atol=1e-6 * want.abs().max().item())
        twin = gaussian_filter_cuda.gaussian_filter_plain(f, vals)
        torch.testing.assert_close(out, twin, rtol=1e-3, atol=1e-6 * twin.abs().max().item())
    assert torch.equal(gaussian_filter_cuda.gaussian_filter_cuda(f, v), got.detach())


@pytest.mark.cuda
def test_gaussian_kernel_refuses_unsupported_shapes(cuda_device):
    f = torch.zeros(1, 8, 5, device=cuda_device)
    v = torch.zeros(1, 8, 3, device=cuda_device)
    with pytest.raises(ValueError, match="feature dims"):
        gaussian_filter_cuda.gaussian_filter_cuda(f[..., :2].contiguous(), v)
    with pytest.raises(ValueError, match="value channels"):
        gaussian_filter_cuda.gaussian_filter_cuda(f, torch.zeros(1, 8, 5, device=cuda_device))
    with pytest.raises(ValueError, match="float32"):
        gaussian_filter_cuda.gaussian_filter_cuda(f.double(), v.double())
    with pytest.raises(ValueError, match="differ in B, N"):
        gaussian_filter_cuda.gaussian_filter_cuda(f, v[:, :4].contiguous())
