"""The CUDA wrappers (gated CRF, Gaussian filter): their checks here, their
kernels on the card.

This file imports no JAX, so the tests marked ``cuda`` run on a machine with
a card and no JAX stack (the repo's conftest imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

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
        gated_crf_cuda.gated_crf_fwd_cuda(y, f, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gated_crf_cuda.gated_crf_bwd_cuda(y, f, 2)
    assert gated_crf_cuda.launches == {"gated_crf_fwd": 0, "gated_crf_bwd": 0}


def test_plain_twin_is_what_cpu_tensors_get():
    rng = np.random.default_rng(1)
    y = torch.softmax(torch.tensor(rng.normal(size=(2, 3, 9, 11)), dtype=torch.float32), 1)
    f = torch.tensor(rng.uniform(size=(2, 5, 9, 11)), dtype=torch.float32)
    gated_crf_cuda.reset_launches()
    got = gated_crf_cuda.gated_crf_potts(y, f, 3)
    assert got.item() == gated_crf_cuda.gated_crf_potts_plain(y, f, 3).item()
    assert gated_crf_cuda.launches["gated_crf_fwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b, c, nf, h, w, r",
    [(2, 3, 5, 37, 70, 5), (1, 2, 3, 9, 33, 2), (3, 4, 3, 16, 16, 1), (12, 3, 5, 64, 64, 5)],
)
def test_kernel_matches_plain_twin(cuda_device, b, c, nf, h, w, r):
    """Value at rtol 1e-5, dL/dy at rtol 1e-4 / atol 1e-6, including ragged
    tiles and every pixel within the radius of a border."""
    rng = np.random.default_rng(b * 100 + h)
    logits = torch.tensor(rng.normal(size=(b, c, h, w)), dtype=torch.float32, device=cuda_device)
    f = torch.tensor(rng.uniform(size=(b, nf, h, w)), dtype=torch.float32, device=cuda_device)
    y = torch.softmax(logits, 1).requires_grad_(True)
    y_ref = y.detach().clone().requires_grad_(True)
    gated_crf_cuda.reset_launches()
    got = gated_crf_cuda.gated_crf_potts(y, f, r)
    want = gated_crf_cuda.gated_crf_potts_plain(y_ref, f, r)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    got.backward()
    want.backward()
    torch.cuda.synchronize()
    torch.testing.assert_close(y.grad, y_ref.grad, rtol=1e-4, atol=1e-6)
    assert gated_crf_cuda.launches == {"gated_crf_fwd": 1, "gated_crf_bwd": 1}
    # no float atomics: the same input gives the bit-identical loss
    assert torch.equal(gated_crf_cuda.gated_crf_fwd_cuda(y.detach(), f, r), got.detach())


@pytest.mark.cuda
def test_kernel_refuses_unsupported_shapes(cuda_device):
    y = torch.zeros(1, 5, 8, 8, device=cuda_device)
    f = torch.zeros(1, 5, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="classes"):
        gated_crf_cuda.gated_crf_fwd_cuda(y, f, 2)
    with pytest.raises(ValueError, match="radius"):
        gated_crf_cuda.gated_crf_fwd_cuda(y[:, :3].contiguous(), f, 6)
    with pytest.raises(ValueError, match="feature channels"):
        gated_crf_cuda.gated_crf_fwd_cuda(y[:, :3].contiguous(), f[:, :4].contiguous(), 2)
    with pytest.raises(ValueError, match="float32"):
        gated_crf_cuda.gated_crf_fwd_cuda(y[:, :3].double().contiguous(), f.double(), 2)


def test_gaussian_wrapper_refuses_cpu_tensors_before_launching():
    gaussian_filter_cuda.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        gaussian_filter_cuda.gaussian_filter_cuda(torch.zeros(1, 8, 5), torch.zeros(1, 8, 3))
    assert gaussian_filter_cuda.launches == {"gaussian_filter": 0}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b, n, d, c",
    [(2, 1000, 5, 3), (1, 37, 3, 1), (3, 513, 4, 4), (1, 2049, 5, 2), (2, 4096, 3, 3), (1, 1, 4, 1)],
)
def test_gaussian_kernel_matches_plain_twin(cuda_device, b, n, d, c):
    """Value and VJP at rtol 1e-4 / atol 1e-6 on non-negative values, with N
    off the 512-row block and the 128-column tile; features spread as the
    dense CRF's do, so most weights are far from 0 and 1."""
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
    # a fixed summation order per output: the same input gives the same bits
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
