"""The fused gated CRF's plain twin and autograd route against fedicra_tpu (CPU).

``gated_crf_potts_fused_plain`` gives the loss and acc(q) = sum_o k_o(q)
y(q+o) of one pass, the loss taken as sum_q [K(q) - <y(q), acc(q)>]. It is
held against the Pallas kernel of ``fedicra_tpu`` in interpret mode (as
tests/test_gated_crf_pallas.py runs it): the loss, and acc scaled by
-2/(B H W) against JAX's gradient with respect to the probabilities. The
identity's cancellation is held on near one-hot maps against a float64 run.
The autograd route is driven here with the twin standing in for the launch,
and ``tools/kernel_times.py``'s count of the pass's least work against an
enumeration.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.losses.gated_crf import gated_crf_features
from fedicra_torch.ops import gated_crf_cuda
from fedicra_tpu.ops.gated_crf_pallas import gated_crf_loss_pallas
from torch_card import confident_logits, smooth_images

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from kernel_times import gated_crf_work  # noqa: E402


def _inputs(seed, b, c, n_img, h, w):
    rng = np.random.default_rng(seed)
    probs = np.array(jax.nn.softmax(jnp.asarray(rng.normal(size=(b, h, w, c)).astype(np.float32)), -1))
    image = rng.uniform(size=(b, h, w, n_img)).astype(np.float32)
    return probs, image


def _planes(probs, image):
    y = torch.from_numpy(probs).permute(0, 3, 1, 2).contiguous()
    f = gated_crf_features(torch.from_numpy(image), 6.0, 0.1).permute(0, 3, 1, 2).contiguous()
    return y, f


@pytest.mark.parametrize("radius", [1, 3, 5])
@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("nf", [3, 5])
def test_fused_twin_matches_pallas(radius, c, nf):
    """Loss at rtol 1e-5; acc * -2/(B H W) against dL/dprobs at rtol 1e-4 /
    atol 1e-6, over a ragged 37 x 70 image (no side a multiple of 32)."""
    b, h, w = 2, 37, 70
    probs, image = _inputs(radius * 10 + c + nf, b, c, nf - 2, h, w)
    value, grad = jax.value_and_grad(
        lambda p: gated_crf_loss_pallas(p, jnp.asarray(image), radius=radius)
    )(jnp.asarray(probs))
    loss, acc = gated_crf_cuda.gated_crf_potts_fused_plain(*_planes(probs, image), radius)
    np.testing.assert_allclose(loss.item(), float(value), rtol=1e-5)
    np.testing.assert_allclose(
        (acc * (-2.0 / (b * h * w))).numpy(), np.transpose(np.asarray(grad), (0, 3, 1, 2)),
        rtol=1e-4, atol=1e-6,
    )


@pytest.mark.parametrize("radius", [3, 5])
def test_identity_form_holds_on_confident_inputs(radius):
    """Near one-hot maps (20x logits of smooth class regions) on a smooth
    guide: K(q) and <y(q), acc(q)> are close and up to ~120, and the fp32
    identity form still gives the float64 twin's loss at rtol 1e-5, as does
    the pair-by-pair form."""
    b, c, h, w = 2, 3, 64, 80
    rng = np.random.default_rng(radius)
    image = torch.from_numpy(smooth_images(rng, b, h, w))
    f = gated_crf_features(image, 6.0, 0.1).permute(0, 3, 1, 2).contiguous()
    y = torch.softmax(torch.from_numpy(confident_logits(rng, b, c, h, w)), 1)
    assert (y.max(dim=1).values > 1 - 1e-6).float().mean() > 0.9  # near one-hot
    loss, acc = gated_crf_cuda.gated_crf_potts_fused_plain(y, f, radius)
    want, acc64 = gated_crf_cuda.gated_crf_potts_fused_plain(y.double(), f.double(), radius)
    assert loss.dtype == torch.float32 and want.dtype == torch.float64
    assert acc.sum(dim=1).max() > 0.5 * ((2 * radius + 1) ** 2 - 1)  # K and <y, acc> large
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-5)
    np.testing.assert_allclose(gated_crf_cuda.gated_crf_potts_plain(y, f, radius).item(),
                               want.item(), rtol=1e-5)
    torch.testing.assert_close(acc.double(), acc64, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("radius", [2, 4])
def test_fused_twin_agrees_with_pairwise_twin(radius):
    """The two plain forms on one input: the same loss, and acc is the
    pairwise loss's gradient scaled by -(B H W)/2."""
    b, c, h, w = 3, 4, 21, 34
    probs, image = _inputs(40 + radius, b, c, 3, h, w)
    y, f = _planes(probs, image)
    y_req = y.clone().requires_grad_(True)
    pairwise = gated_crf_cuda.gated_crf_potts_plain(y_req, f, radius)
    (grad,) = torch.autograd.grad(pairwise, y_req)
    loss, acc = gated_crf_cuda.gated_crf_potts_fused_plain(y, f, radius)
    np.testing.assert_allclose(loss.item(), pairwise.item(), rtol=1e-5)
    torch.testing.assert_close(acc * (-2.0 / (b * h * w)), grad, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("h, w, r", [(37, 70, 5), (9, 8, 5), (16, 16, 1)])
def test_gated_crf_work_counts_pairs_inside_once(h, w, r):
    """The bound's count of the pass's least work against an enumeration of
    every (pixel, offset) pair, down to images narrower than the window."""
    b, c, nf = 2, 3, 5
    inside = 0
    border = set()
    for qy in range(h):
        for qx in range(w):
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    if dy or dx:
                        if 0 <= qy + dy < h and 0 <= qx + dx < w:
                            inside += 1
                        else:
                            border.add((qy, qx))
    ops = (inside // 2 * 3 * nf + inside * (2 * c + 1) + len(border) * (2 * nf + 2)
           + h * w * (2 * c + 2))
    assert gated_crf_work(b, c, nf, h, w, r) == (b * ops, b * (inside // 2 + len(border)))


@pytest.fixture
def twin_as_launch(monkeypatch):
    """The kernel route on CPU tensors, the fused twin standing in for the
    launch (counted as one); records each call's ``need_acc``."""
    calls = []

    def launch(y, feats, radius, need_acc=True):
        calls.append(need_acc)
        gated_crf_cuda.launches["gated_crf"] += 1
        loss, acc = gated_crf_cuda.gated_crf_potts_fused_plain(y, feats, radius)
        return loss, acc if need_acc else None

    monkeypatch.setattr(gated_crf_cuda, "gated_crf_fused_cuda", launch)
    gated_crf_cuda.reset_launches()
    yield calls
    gated_crf_cuda.reset_launches()


def _route_inputs():
    probs, image = _inputs(5, 2, 3, 3, 13, 19)
    return _planes(probs, image)


def test_route_launches_once_per_forward_and_not_in_backward(twin_as_launch):
    y, f = _route_inputs()
    y_req = y.clone().requires_grad_(True)
    loss = gated_crf_cuda._gated_crf_potts_kernel(y_req, f, 3)
    assert twin_as_launch == [True]
    loss.backward()
    assert twin_as_launch == [True] and gated_crf_cuda.launches == {"gated_crf": 1}
    y_ref = y.clone().requires_grad_(True)
    gated_crf_cuda.gated_crf_potts_plain(y_ref, f, 3).backward()
    np.testing.assert_allclose(loss.item(), gated_crf_cuda.gated_crf_potts_plain(y, f, 3).item(), rtol=1e-5)
    torch.testing.assert_close(y_req.grad, y_ref.grad, rtol=1e-4, atol=1e-7)


def test_route_keeps_saved_acc_through_a_second_backward(twin_as_launch):
    y, f = _route_inputs()
    y_req = y.clone().requires_grad_(True)
    loss = gated_crf_cuda._gated_crf_potts_kernel(y_req, f, 3)
    (g1,) = torch.autograd.grad(loss, y_req, retain_graph=True)
    (g2,) = torch.autograd.grad(loss, y_req)
    assert torch.equal(g1, g2)  # a backward that scaled the saved acc in place fails here
    _, acc = gated_crf_cuda.gated_crf_potts_fused_plain(y, f, 3)
    assert torch.equal(g1, acc * (-2.0 / y[:, 0].numel()))
    assert twin_as_launch == [True]


@pytest.mark.parametrize("mode", ["no_grad", "y_needs_no_grad"])
def test_route_asks_for_no_acc_without_a_gradient(twin_as_launch, mode):
    y, f = _route_inputs()
    want = gated_crf_cuda.gated_crf_potts_plain(y, f, 3).item()
    if mode == "no_grad":
        with torch.no_grad():
            loss = gated_crf_cuda._gated_crf_potts_kernel(y.clone().requires_grad_(True), f, 3)
    else:
        loss = gated_crf_cuda._gated_crf_potts_kernel(y, f, 3)
    assert twin_as_launch == [False] and not loss.requires_grad
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
