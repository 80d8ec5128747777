"""The gated-CRF CUDA wrapper: its checks here, its kernel on the card.

This file imports no JAX, so the tests marked ``cuda`` run on a machine with
a card and no JAX stack (the repo's conftest imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from fedicra_torch.ops import gated_crf_cuda


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
