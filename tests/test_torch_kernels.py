"""The CUDA wrappers (fused gated CRF, Gaussian filter, the tree chain): their
checks here, their kernels on the card.

This file imports no JAX, so the tests marked ``cuda`` run on a machine with
a card and no JAX stack (the repo's conftest imports JAX, hence
``--noconftest``); the README names the command that runs every card test.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedicra_torch.losses.gated_crf import gated_crf_features
from fedicra_torch.ops import gated_crf_cuda, gaussian_filter_cuda, tree_filter_cuda
from torch_card import (MST_TILE_LOCAL_BYTES, MST_TILE_REGISTERS, confident_logits,  # noqa: F401
                        cuda_device, serpentine_weights, smooth_images, tree_guides)


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


def _confident_inputs(rng, b, c, h, w, nf=5):
    """Near one-hot maps over smooth class regions and the gated CRF's
    features of a smooth image of nf - 2 channels, where K(q) and
    <y(q), acc(q)> nearly cancel."""
    image = torch.as_tensor(smooth_images(rng, b, h, w, nf - 2))
    f = gated_crf_features(image, 6.0, 0.1).permute(0, 3, 1, 2).contiguous()
    return confident_logits(rng, b, c, h, w), f.numpy()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b, c, nf, h, w, r, confident",
    [(2, 3, 5, 37, 70, 5, False), (1, 2, 3, 9, 33, 2, False), (3, 4, 3, 16, 16, 1, False),
     (12, 3, 5, 64, 64, 5, False), (2, 4, 5, 40, 72, 4, False), (2, 3, 5, 37, 70, 5, True),
     (12, 3, 5, 64, 64, 5, True),
     # FAZ (2 classes, a gray image: F = 3) and Polyp (2 classes, rgb: F = 5) at batch 12
     (12, 2, 3, 128, 128, 5, False), (12, 2, 3, 128, 128, 5, True),
     (12, 2, 5, 96, 96, 5, False), (12, 2, 5, 96, 96, 5, True),
     # a step of each task: ODOC, FAZ, Polyp
     (12, 3, 5, 384, 384, 5, False), (12, 3, 5, 384, 384, 5, True),
     (12, 2, 3, 256, 256, 5, False), (12, 2, 3, 256, 256, 5, True),
     (12, 2, 5, 384, 384, 5, False), (12, 2, 5, 384, 384, 5, True)],
)
def test_kernel_matches_plain_twin(cuda_device, b, c, nf, h, w, r, confident):
    """Loss at rtol 1e-5 against the fused twin, the pairwise twin and the
    fused twin in float64, and acc at rtol 1e-4 / atol 1e-6 against the
    fused twin, including ragged tiles, every pixel within the radius of a
    border and near one-hot maps; one launch per forward and none in the
    backward, whose dL/dy is -2/(B H W) acc; the same input gives the same
    bits, with acc written or not."""
    rng = np.random.default_rng(b * 100 + h)
    if confident:  # xy + the smooth image's nf - 2 channels
        logits, f = _confident_inputs(rng, b, c, h, w, nf)
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
    exact, _ = gated_crf_cuda.gated_crf_potts_fused_plain(y.detach().double(), f.double(), r)
    torch.testing.assert_close(got.detach().double(), exact, rtol=1e-5, atol=0)
    loss, acc = gated_crf_cuda.gated_crf_fused_cuda(y.detach(), f, r)
    torch.testing.assert_close(acc, want_acc, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(y.grad, want_acc * (-2.0 / (b * h * w)), rtol=1e-4, atol=1e-6)
    # no float atomics: the same input gives the bit-identical loss and acc
    loss2, acc2 = gated_crf_cuda.gated_crf_fused_cuda(y.detach(), f, r)
    assert torch.equal(loss, got.detach()) and torch.equal(loss2, loss) and torch.equal(acc2, acc)
    loss_n, acc_n = gated_crf_cuda.gated_crf_fused_cuda(y.detach(), f, r, need_acc=False)
    assert acc_n is None and torch.equal(loss_n, loss)


KERNEL_SHAPES = [
    (2, 3, 5, 37, 70, 5, False), (1, 2, 3, 9, 33, 2, False), (3, 4, 3, 16, 16, 1, False),
    (12, 3, 5, 64, 64, 5, False), (2, 4, 5, 40, 72, 4, False), (2, 3, 5, 37, 70, 5, True),
    (12, 3, 5, 64, 64, 5, True), (12, 3, 5, 384, 384, 5, False), (12, 3, 5, 384, 384, 5, True),
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


def _direct_float64(feats: torch.Tensor, values: torch.Tensor, rows=None) -> torch.Tensor:
    """sum_j exp(-1/2 ||f_i - f_j||^2) v_j in float64 from direct differences,
    over every row i or over the rows ``rows`` of each image."""
    f = feats.double()
    if rows is None:
        d2 = ((f[:, :, None, :] - f[:, None, :, :]) ** 2).sum(-1)
        return torch.exp(-0.5 * d2) @ values.double()
    out, rows = [], rows.to(f.device)
    for k in range(f.shape[0]):  # one image at a time: (rows, N, D) differences
        d2 = ((f[k, rows][:, None, :] - f[k][None, :, :]) ** 2).sum(-1)
        out.append(torch.exp(-0.5 * d2) @ values[k].double())
    return torch.stack(out)


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, w, c", [(2, 37, 41, 3), (2, 48, 48, 4), (2, 23, 61, 1),
                                        # the dense CRF's filter beside ODOC's step: N = 192^2
                                        (12, 192, 192, 3)])
def test_gaussian_kernel_on_white_regions_matches_float64(cuda_device, b, h, w, c):
    """Dense-CRF features ([x/50, y/50, rgb/15] of a smooth image scaled to
    0..255) with a white square, where |f|^2 reaches ~900 and the expanded
    exponent's terms cancel most: value and VJP at rtol 1e-4 against a
    float64 direct sum (on 256 rows of each image where N passes 4096), and
    at rtol 1e-3 against the fp32 twin, which carries ~1e-4 of each
    exponent's rounding there (atol 1e-6 of its largest output; 1e-5 where
    N passes 4096); two launches, forward and VJP; same bits."""
    rng = np.random.default_rng(h * w)
    img = smooth_images(rng, b, h, w)
    img[:, h // 4:h // 2 + 3, w // 3:w // 3 + w // 2] = 1.0
    f = gaussian_filter_cuda.bilateral_features(
        torch.as_tensor(img, device=cuda_device) * 255.0, 15.0, 50.0).contiguous()
    assert (f * f).sum(-1).max().item() > 850.0
    v = torch.tensor(rng.uniform(size=(b, h * w, c)), dtype=torch.float32, device=cuda_device)
    g = torch.tensor(rng.uniform(size=(b, h * w, c)), dtype=torch.float32, device=cuda_device)
    v_k = v.clone().requires_grad_(True)
    gaussian_filter_cuda.reset_launches()
    got = gaussian_filter_cuda.gaussian_kernel_filter(f, v_k)
    (dv,) = torch.autograd.grad(got, v_k, g)
    torch.cuda.synchronize()
    assert gaussian_filter_cuda.launches == {"gaussian_filter": 2}
    rows = None if h * w <= 4096 else torch.linspace(0, h * w - 1, 256).round().long().unique()
    for out, vals in ((got.detach(), v), (dv, g)):
        want = _direct_float64(f, vals, rows)
        sub = out if rows is None else out[:, rows.to(cuda_device)]
        torch.testing.assert_close(sub.double(), want, rtol=1e-4, atol=1e-6 * want.abs().max().item())
        twin = gaussian_filter_cuda.gaussian_filter_plain(f, vals)
        atol = 1e-6 * twin.abs().max().item() if rows is None else 1e-5
        torch.testing.assert_close(out, twin, rtol=1e-3, atol=atol)
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


def _tree_guides(dev, rng, b, h, w, c, guides):
    """The guides' rows [T b, V, D] (a low tree's b images first, then the
    high trees'), zero-padded to the widest, and each high tree's own guide
    [b, V, c]. ``random``: one low and one high tree of normal guides;
    ``gray``: the low guide one channel on 256 levels (zero-padded to c, as
    ``native_structures`` pads it); ``step`` and ``step_gray``: a step's
    four trees from ``tree_guides`` (the low guide 3 channels, or a gray
    image repeated to 3 channels, as the objective repeats it)."""
    V = h * w
    if guides.startswith("step"):
        low, highs = tree_guides(dev, rng, b, h, w, c, channels=1 if guides == "step_gray" else 3)
        flats = [g.reshape(b, V, -1) for g in (low, *highs)]
        d = max(t.shape[-1] for t in flats)
        emb = torch.cat([F.pad(t, (0, d - t.shape[-1])) for t in flats]).contiguous()
        return emb, [t.contiguous() for t in flats[1:]]
    emb = torch.tensor(rng.normal(size=(2 * b, V, c)), dtype=torch.float32, device=dev)
    if guides == "gray":
        emb[:b, :, 1:] = 0.0
        emb[:b, :, 0] = torch.tensor(np.round(rng.uniform(size=(b, V)) * 255.0) / 255.0,
                                     dtype=torch.float32, device=dev)
    return emb, [emb[b:].contiguous()]


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, w, c, guides", [
    (2, 12, 12, 3, "random"), (3, 17, 40, 2, "random"), (2, 64, 48, 4, "random"),
    (1, 1, 9, 1, "random"), (2, 256, 256, 2, "gray"),
    # a step's four trees of 12 images: ODOC's, FAZ's
    (12, 384, 384, 3, "step"), (12, 256, 256, 2, "step_gray")])
def test_tree_kernels_match_plain_twins(cuda_device, b, h, w, c, guides):
    """The four tree kernels against their twins on the same inputs: the MST
    (V - 1 edges an image) and the BFS arrays exactly (levels up to each
    image's count), the weights at rtol 1e-6, each tree's filter y at rtol
    1e-4 and its backward at rtol 1e-3; one MST and one rooting launch for
    all trees, one filter launch each way a tree. The MST's weights are the
    objective's, ||d guide||^2 + 1. D = 1 (``gray``) is a function-level
    case: FAZ's objective repeats its gray image to 3 channels, which
    ``step_gray`` holds."""
    from fedicra_torch.ops.mst import grid_edges

    rng = np.random.default_rng(h * w)
    V = h * w
    eu, ev = (torch.as_tensor(a, device=cuda_device).long() for a in grid_edges(h, w))
    emb, high_embeds = _tree_guides(cuda_device, rng, b, h, w, c, guides)
    weights = ((emb[:, eu] - emb[:, ev]) ** 2).sum(-1) + 1.0
    tree_filter_cuda.reset_launches()
    sel = tree_filter_cuda.tree_mst(weights, h, w)
    assert (sel.sum(dim=1) == V - 1).all()
    assert torch.equal(sel, tree_filter_cuda.tree_mst_plain(weights, h, w))
    tree = tree_filter_cuda.tree_root(sel, emb, h, w, b, 0.02)
    used = torch.arange(V + 1, device=cuda_device) <= tree.n_levels[:, None].long()
    # two launches give the same bits (the level offsets past each image's count are not written)
    again = tree_filter_cuda.tree_root_cuda(sel, emb, h, w, b, 0.02)
    for name, first, second in zip(tree_filter_cuda.BFSTree._fields, tree, again):
        if name == "level":
            first, second = first[used], second[used]
        assert torch.equal(first, second), f"K2 gave two {name} arrays on the same inputs"
    twin = tree_filter_cuda.tree_root_plain(sel, emb, h, w, b, 0.02)
    for name in ("order", "parent", "ppos", "cptr", "n_levels"):
        assert torch.equal(getattr(tree, name), getattr(twin, name)), name
    assert torch.equal(tree.level[used], twin.level[used])
    torch.testing.assert_close(tree.w, twin.w, rtol=1e-6, atol=1.2e-38)
    x = torch.softmax(torch.tensor(rng.normal(size=(b, V, c)), dtype=torch.float32,
                                   device=cuda_device), -1)
    g = torch.tensor(rng.normal(size=(b, V, c)), dtype=torch.float32, device=cuda_device)
    for k, e in enumerate([None, *high_embeds]):
        t = tree.images(k * b, (k + 1) * b)
        A, F_, y = tree_filter_cuda.tree_filter_fwd_cuda(x, t)
        torch.testing.assert_close(y, tree_filter_cuda.tree_filter_fwd_plain(x, t)[2],
                                   rtol=1e-4, atol=1e-5)
        got = tree_filter_cuda.tree_filter_bwd_cuda(g, y, A, F_, t, e)
        want = tree_filter_cuda.tree_filter_bwd_plain(g, y, A, F_, t, e)
        for a, bb in zip(got, want):
            if bb is None:
                assert a is None
                continue
            torch.testing.assert_close(a, bb, rtol=1e-3, atol=1e-4 * bb.abs().max().item())
    torch.cuda.synchronize()
    trees = 1 + len(high_embeds)
    assert tree_filter_cuda.launches == {"tree_mst": 1, "tree_root": 2, "tree_fwd": trees,
                                         "tree_bwd": trees}


def _comb_weights(h, w):
    """MST weights whose tree is row 0 and every column hanging from it: the
    level of (i, j) is i + j, so the middle levels hold min(h, w) vertices."""
    from fedicra_torch.ops.mst import grid_edges

    eu, ev = grid_edges(h, w)
    horizontal = ev == eu + 1
    return np.where(~horizontal | (eu < w), 1.0, 10.0).astype(np.float32)


def _filter_both_trees(b, h, w, c, weights, rng, dev, **instance):
    """K3 and K4 on b low trees and b high trees of one MST (the same
    structure, the weights from random guides), with a passes instance;
    returns the trees and ((y, dx, d embed) of the low, of the high)."""
    V = h * w
    emb = torch.tensor(rng.normal(size=(2 * b, V, c)), dtype=torch.float32, device=dev)
    sel = tree_filter_cuda.tree_mst(weights.expand(2 * b, -1).contiguous(), h, w)
    tree = tree_filter_cuda.tree_root(sel, emb, h, w, b, 0.02)
    x = torch.softmax(torch.tensor(rng.normal(size=(b, V, c)), dtype=torch.float32, device=dev), -1)
    g = torch.tensor(rng.normal(size=(b, V, c)), dtype=torch.float32, device=dev)
    out = []
    for k, embed in ((0, None), (1, emb[b:].contiguous())):
        t = tree.images(k * b, (k + 1) * b)
        launches = dict(tree_filter_cuda.launches)
        A, F, y = tree_filter_cuda.tree_filter_fwd_cuda(x, t, **instance)
        dx, de = tree_filter_cuda.tree_filter_bwd_cuda(g, y, A, F, t, embed, **instance)
        torch.cuda.synchronize()
        assert tree_filter_cuda.launches["tree_fwd"] == launches["tree_fwd"] + 1
        assert tree_filter_cuda.launches["tree_bwd"] == launches["tree_bwd"] + 1
        out.append((t, x, g, embed, (A, F, y), (dx, de)))
    return tree, out


@pytest.mark.cuda
@pytest.mark.parametrize("kind, h, w, window", [
    ("serpentine", 32, 32, tree_filter_cuda.WINDOW),
    ("serpentine", 96, 96, tree_filter_cuda.WINDOW),
    ("serpentine", 33, 37, tree_filter_cuda.SMALL_WINDOW),
    ("comb", 96, 80, tree_filter_cuda.SMALL_WINDOW),
    ("comb", 96, 80, tree_filter_cuda.WINDOW),
])
def test_tree_filter_kernels_on_deep_and_wide_trees(cuda_device, kind, h, w, window):
    """K3's y and K4's dx and d embed against the twins (rtol 1e-4 / 1e-3,
    as on the main path's trees) on a path-shaped tree (depth V - 1; at 96^2
    more levels than the passes keep in shared memory, so their offsets are
    streamed) and on a comb, whose middle levels with the level they read
    span more than the small window's 64 positions; one launch counted a
    call. The small window gives the main window's bits."""
    b, c, V = 2, 3, h * w
    rng = np.random.default_rng(V)
    make = serpentine_weights if kind == "serpentine" else _comb_weights
    weights = torch.tensor(make(h, w), device=cuda_device)
    tree_filter_cuda.reset_launches()
    tree, runs = _filter_both_trees(b, h, w, c, weights, rng, cuda_device, window=window)
    levels = tree.level.long().cpu()
    n_levels = int(tree.n_levels[0])
    if kind == "serpentine":
        assert (tree.n_levels == V).all()
    else:
        span = max(int(levels[0, min(L + 2, n_levels)] - levels[0, L]) for L in range(n_levels))
        assert span > tree_filter_cuda.SMALL_WINDOW and n_levels == h + w - 1
    for t, x, g, embed, (A, F, y), (dx, de) in runs:
        torch.testing.assert_close(y, tree_filter_cuda.tree_filter_fwd_plain(x, t)[2], rtol=1e-4, atol=1e-5)
        want = tree_filter_cuda.tree_filter_bwd_plain(g, y, A, F, t, embed)
        for a, bb in zip((dx, de), want):
            if bb is None:
                assert a is None
                continue
            torch.testing.assert_close(a, bb, rtol=1e-3, atol=1e-4 * bb.abs().max().item())
        # the same sums in the same order whatever the window
        if window != tree_filter_cuda.WINDOW:
            A2, F2, y2 = tree_filter_cuda.tree_filter_fwd_cuda(x, t)
            dx2, de2 = tree_filter_cuda.tree_filter_bwd_cuda(g, y, A, F, t, embed)
            assert torch.equal(A2, A) and torch.equal(F2, F) and torch.equal(y2, y)
            assert torch.equal(dx2, dx) and (de is None or torch.equal(de2, de))


@pytest.mark.cuda
def test_tree_filter_stamps_time_each_pass(cuda_device):
    """The passes' %globaltimer stamps: start <= between passes <= end on
    every image, and the outputs equal an unstamped launch's."""
    b, h, w, c = 3, 40, 40, 3
    rng = np.random.default_rng(5)
    weights = torch.tensor(rng.uniform(1, 2, size=tree_filter_cuda.num_grid_edges(h, w)),
                           dtype=torch.float32, device=cuda_device)
    _, runs = _filter_both_trees(b, h, w, c, weights, rng, cuda_device)
    t, x, g, embed, (A, F, y), (dx, de) = runs[1]
    stamps = torch.zeros((b, 3), dtype=torch.int64, device=cuda_device)
    assert torch.equal(tree_filter_cuda.tree_filter_fwd_cuda(x, t, stamps=stamps)[2], y)
    assert (stamps[:, 0] > 0).all() and (stamps[:, 1] >= stamps[:, 0]).all()
    assert (stamps[:, 2] >= stamps[:, 1]).all()
    stamps.zero_()
    assert torch.equal(tree_filter_cuda.tree_filter_bwd_cuda(g, y, A, F, t, embed, stamps=stamps)[1], de)
    assert (stamps[:, 0] > 0).all() and (stamps[:, 2] >= stamps[:, 1]).all()


def _structure_weights(kind, h, w, rng):
    """MST weights [E]: random, all equal (the edge index decides every tie),
    a path-shaped tree or a comb."""
    E = tree_filter_cuda.num_grid_edges(h, w)
    if kind == "random":
        return rng.uniform(1.0, 2.0, E).astype(np.float32)
    if kind == "equal":
        return np.ones(E, np.float32)
    return serpentine_weights(h, w) if kind == "serpentine" else _comb_weights(h, w)


def _hold_tree(got, want):
    """K2's arrays exactly the twin's (levels up to each image's count), w at rtol 1e-6."""
    for name in ("order", "parent", "ppos", "cptr", "n_levels"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    used = torch.arange(got.level.shape[1], device=got.level.device) <= want.n_levels[:, None].long()
    assert torch.equal(got.level[used], want.level[used])
    torch.testing.assert_close(got.w, want.w, rtol=1e-6, atol=1.2e-38)


STRUCTURE_CASES = [  # (kind, images, h, w): ragged tiles, 1 x N and N x 1 grids
    ("random", 3, 33, 37), ("random", 2, 64, 48), ("random", 1, 1, 200), ("random", 1, 200, 1),
    ("equal", 2, 33, 37), ("equal", 1, 1, 70), ("serpentine", 1, 33, 37), ("serpentine", 1, 64, 64),
    ("comb", 1, 96, 80),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind, n, h, w", STRUCTURE_CASES)
def test_tree_mst_and_root_instances_match_twins(cuda_device, kind, n, h, w):
    """K1 at both tiles (the main path's, 32, and the tests' 8 with its small
    contracted store) bit for bit the twin's MST; K2 at both rings (the main
    path's, and the 16-entry one that reads its masks from device memory)
    the twin's arrays exactly; a second launch of each the same bits; one
    launch counted a call."""
    rng = np.random.default_rng(h * w + n)
    weights = torch.tensor(np.stack([_structure_weights(kind, h, w, rng) for _ in range(n)]),
                           device=cuda_device)
    want = tree_filter_cuda.tree_mst_plain(weights, h, w)
    tree_filter_cuda.reset_launches()
    tiles = (tree_filter_cuda.MST_TILE, tree_filter_cuda.SMALL_MST_TILE)
    rings = (tree_filter_cuda.RING, tree_filter_cuda.SMALL_RING)
    for tile in tiles:
        sel = tree_filter_cuda.tree_mst_cuda(weights, h, w, tile=tile)
        again = tree_filter_cuda.tree_mst_cuda(weights, h, w, tile=tile)
        assert torch.equal(sel, want) and torch.equal(again, sel), f"tile {tile}"
    emb = torch.tensor(rng.normal(size=(n, h * w, 3)), dtype=torch.float32, device=cuda_device)
    twin = tree_filter_cuda.tree_root_plain(want, emb, h, w, max(n // 2, 1), 0.02)
    for ring in rings:
        got = tree_filter_cuda.tree_root_cuda(want, emb, h, w, max(n // 2, 1), 0.02, ring=ring)
        _hold_tree(got, twin)
        _hold_tree(tree_filter_cuda.tree_root_cuda(want, emb, h, w, max(n // 2, 1), 0.02, ring=ring), got)
    torch.cuda.synchronize()
    assert tree_filter_cuda.launches == {"tree_mst": 2 * len(tiles), "tree_root": 2 * len(rings),
                                         "tree_fwd": 0, "tree_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("h, w, tile", [(64, 48, tree_filter_cuda.SMALL_MST_TILE), (1024, 1024, None)])
def test_tree_mst_contracted_graph_on_device_memory(cuda_device, h, w, tile):
    """An image whose contracted graph does not fit one block's shared memory
    (the tests' store at 64 x 48; the main store at 1024^2 of random
    weights) runs its first phase-2 rounds on device memory: the MST is the
    twin's bit for bit, and the counts show those rounds."""
    tile = tile or tree_filter_cuda.MST_TILE
    rng = np.random.default_rng(h)
    weights = torch.tensor(rng.uniform(1.0, 2.0, (1, tree_filter_cuda.num_grid_edges(h, w))),
                           dtype=torch.float32, device=cuda_device)
    counts = torch.zeros((1, 5), dtype=torch.int32, device=cuda_device)
    sel = tree_filter_cuda.tree_mst_cuda(weights, h, w, tile=tile, counts=counts)
    assert torch.equal(sel, tree_filter_cuda.tree_mst_plain(weights, h, w))
    p1_rounds, components, edges, p2_rounds, device_rounds = counts[0].tolist()
    assert p1_rounds >= 1 and components > 1 and edges >= components - 1
    assert 1 <= device_rounds <= p2_rounds


@pytest.mark.cuda
def test_tree_root_levels_wider_than_the_ring(cuda_device):
    """A comb's middle levels are wider than the 16-entry ring, so they run
    on device memory; the arrays equal the main instance's and the twin's."""
    h, w = 96, 80
    weights = torch.tensor(_comb_weights(h, w), device=cuda_device)[None].contiguous()
    sel = tree_filter_cuda.tree_mst_cuda(weights, h, w)
    emb = torch.rand((1, h * w, 2), device=cuda_device)
    small = tree_filter_cuda.tree_root_cuda(sel, emb, h, w, 1, 0.02, ring=tree_filter_cuda.SMALL_RING)
    widest = int(torch.diff(small.level[0, :int(small.n_levels[0]) + 1].long()).max())
    assert widest > tree_filter_cuda.SMALL_RING
    _hold_tree(small, tree_filter_cuda.tree_root_plain(sel, emb, h, w, 1, 0.02))
    _hold_tree(small, tree_filter_cuda.tree_root_cuda(sel, emb, h, w, 1, 0.02))


@pytest.mark.cuda
def test_tree_mst_and_root_stamps_and_counts(cuda_device):
    """K1's stamps (phase 1's start and end, phase 2's) and counts, and K2's
    BFS stamps: in order on every image, and the outputs an unstamped
    launch's."""
    b, h, w = 3, 100, 70
    rng = np.random.default_rng(3)
    weights = torch.tensor(rng.uniform(1, 2, (b, tree_filter_cuda.num_grid_edges(h, w))),
                           dtype=torch.float32, device=cuda_device)
    stamps = torch.zeros((b, 4), dtype=torch.int64, device=cuda_device)
    counts = torch.zeros((b, 5), dtype=torch.int32, device=cuda_device)
    sel = tree_filter_cuda.tree_mst_cuda(weights, h, w, counts=counts, stamps=stamps)
    assert torch.equal(sel, tree_filter_cuda.tree_mst_cuda(weights, h, w))
    assert (stamps[:, 0] > 0).all() and (stamps[:, 1] >= stamps[:, 0]).all()
    assert (stamps[:, 2] >= stamps[:, 1]).all() and (stamps[:, 3] >= stamps[:, 2]).all()
    assert (counts[:, 0] >= 1).all() and (counts[:, 1] > 1).all() and (counts[:, 3] >= 1).all()
    emb = torch.rand((b, h * w, 3), device=cuda_device)
    bfs = torch.zeros((b, 2), dtype=torch.int64, device=cuda_device)
    tree = tree_filter_cuda.tree_root_cuda(sel, emb, h, w, 1, 0.02, stamps=bfs)
    _hold_tree(tree, tree_filter_cuda.tree_root_cuda(sel, emb, h, w, 1, 0.02))
    assert (bfs[:, 0] > 0).all() and (bfs[:, 1] >= bfs[:, 0]).all()


@pytest.mark.cuda
def test_tree_mst_tile_kernel_register_budget(cuda_device):
    """K1's phase-1 kernel asks for two 1,024-thread blocks an SM, so at most
    32 registers a thread; its spills to local memory stay within the bytes
    the measured build took."""
    regs, local = tree_filter_cuda.mst_tile_registers()
    assert 0 < regs <= MST_TILE_REGISTERS and local <= MST_TILE_LOCAL_BYTES


@pytest.mark.cuda
def test_tree_kernels_refuse_unsupported_inputs(cuda_device):
    h, w = 4, 5
    E, V = tree_filter_cuda.num_grid_edges(h, w), h * w
    with pytest.raises(ValueError, match="contiguous"):
        tree_filter_cuda.tree_mst_cuda(torch.ones(2, E + 1, device=cuda_device), h, w)
    with pytest.raises(ValueError, match="float32"):
        tree_filter_cuda.tree_mst_cuda(torch.ones(2, E, device=cuda_device).double(), h, w)
    sel = tree_filter_cuda.tree_mst_cuda(torch.rand(1, E, device=cuda_device) + 1, h, w)
    with pytest.raises(ValueError, match="embedding channels"):
        tree_filter_cuda.tree_root_cuda(sel, torch.zeros(1, V, 9, device=cuda_device), h, w, 1, 0.02)
    tree = tree_filter_cuda.tree_root_cuda(sel, torch.zeros(1, V, 3, device=cuda_device), h, w, 1, 0.02)
    with pytest.raises(ValueError, match="channels"):
        tree_filter_cuda.tree_filter_fwd_cuda(torch.zeros(1, V, 5, device=cuda_device), tree)
    x = torch.zeros(1, V, 3, device=cuda_device)
    with pytest.raises(ValueError, match="no passes instance"):
        tree_filter_cuda.tree_filter_fwd_cuda(x, tree, window=128)
    with pytest.raises(ValueError, match="no passes instance"):
        tree_filter_cuda.tree_filter_bwd_cuda(x, x, torch.zeros(1, V, 4, device=cuda_device),
                                              torch.zeros(1, V, 4, device=cuda_device), tree, None,
                                              window=32)
    with pytest.raises(ValueError, match="stamps"):
        tree_filter_cuda.tree_filter_fwd_cuda(x, tree, stamps=torch.zeros(1, 3, device=cuda_device))
    weights = torch.rand(1, E, device=cuda_device) + 1
    with pytest.raises(ValueError, match="no MST instance"):
        tree_filter_cuda.tree_mst_cuda(weights, h, w, tile=16)
    with pytest.raises(ValueError, match="no MST instance"):
        tree_filter_cuda.tree_mst_cuda(weights, h, w, tile=64)
    with pytest.raises(ValueError, match="counts"):
        tree_filter_cuda.tree_mst_cuda(weights, h, w, counts=torch.zeros(1, 4, dtype=torch.int32,
                                                                        device=cuda_device))
    with pytest.raises(ValueError, match="stamps"):
        tree_filter_cuda.tree_mst_cuda(weights, h, w, stamps=torch.zeros(1, 4, device=cuda_device))
    emb = torch.zeros(1, V, 3, device=cuda_device)
    with pytest.raises(ValueError, match="no BFS instance"):
        tree_filter_cuda.tree_root_cuda(sel, emb, h, w, 1, 0.02, ring=32)
    with pytest.raises(ValueError, match="no BFS instance"):
        tree_filter_cuda.tree_root_cuda(sel, emb, h, w, 1, 0.02, ring=2 * tree_filter_cuda.RING)
    with pytest.raises(ValueError, match="stamps"):
        tree_filter_cuda.tree_root_cuda(sel, emb, h, w, 1, 0.02,
                                        stamps=torch.zeros(1, 3, dtype=torch.int64, device=cuda_device))
