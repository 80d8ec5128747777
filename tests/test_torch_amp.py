"""Mixed precision (``--amp 1``): the port's bf16 path against fedicra_tpu's (CPU).

JAX's AMP is not ``torch.autocast``: ``Conv`` computes in bf16, BatchNorm
casts its input to fp32, the DSN heads and every bare ``nn.Conv`` stay fp32,
and the softmax, pCE and contrast term take the bf16 logits and heatmap as
they come. The port copies those cast points (``tests/test_torch_amp_dtypes.py``
holds the dtype map of every model type); here the first "ours" step at
tree weight 0.1 is held to JAX's AMP step.

Numbers: JAX's AMP reference is compiled with XLA's excess precision off
(``xla_allow_excess_precision=False``), so it rounds every bf16 operation as
written, as JAX's op-by-op execution and the port do; the default compile
may skip roundings inside a fusion. The distance ||port_amp - jax_amp|| is
held as a share of JAX's own AMP-to-fp32 gap ||jax_amp - jax_fp32||, under
half of it, beside an absolute bound; the port's fp32 step, which ignores
AMP, sits at the whole gap and fails. In bf16 a sum accumulated in another
order lands a bf16 step away now and then, and train-mode BatchNorm spreads
each such flip to later layers: ``test_cpu_convolutions_round_once`` shows
why the port's CPU convolutions sum in fp32, as XLA's do.
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.convert import state_dict_to_flax
from fedicra_torch.engine import objective as port_obj
from fedicra_torch.models.blocks import compute_dtype
from fedicra_tpu.engine import objective as jax_obj
from torch_port_helpers import (  # noqa: F401
    batch, compile_exact, configs, flat, jax_amp, models, one_torch_thread, port_stats, t)

CID = 1
# the first step's bounds: the share of JAX's AMP-to-fp32 gap, and beside it
# the absolute distance (L2 over every gradient or running statistic)
GAP_SHARE = 0.5
GRAD_ATOL, STATS_ATOL = 0.3, 0.02


@pytest.fixture(scope="module")
def fp32_tree_filter_input():
    """JAX's AMP step with the tree term on cannot take a gradient: its tree
    filter carries a bf16 softmax into an fp32 scan (a TypeError, and on the
    host path a bf16 cotangent meets an fp32 one). The port widens the
    filter's input to fp32 and rounds the gradient back; here JAX's filter is
    given the same cast, so both run the design the port implements."""
    tf = importlib.import_module("fedicra_tpu.ops.tree_filter")
    refine = tf.tree_filter_refine
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tf, "tree_filter_refine", lambda x, *a: refine(x.astype(jnp.float32), *a))
        yield


def _vec(tree):
    d = dict(flat(tree))
    return np.concatenate([np.asarray(d[k], np.float32).ravel() for k in sorted(d)])


def _port_step(amp):
    _, pcfg = configs(tree_loss_weight=0.1)
    _, _, pm = models()
    image, label = batch(seed=CID)
    pm.train()
    with compute_dtype(torch.bfloat16 if amp else None):
        loss, metrics = port_obj.ours_loss(pm, {"image": t(image), "label": t(label)}, CID, pcfg)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in pm.named_parameters()}
    grads.update(dict(pm.named_buffers()))
    return loss, metrics, state_dict_to_flax(grads)[0], port_stats(pm)


@pytest.fixture(scope="module")
def jax_steps(fp32_tree_filter_input):
    """JAX's first "ours" step at tree weight 0.1, fp32 and AMP."""
    jcfg, _ = configs(tree_loss_weight=0.1)
    jm, v, _ = models()
    image, label = batch(seed=CID)
    data = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    steps = {}
    for amp in (False, True):
        def loss_fn(p):
            return jax_obj.ours_loss(jm, p, v["batch_stats"], jax.random.PRNGKey(0), data,
                                     jnp.asarray(CID, jnp.int32), jcfg)

        vg = jax.value_and_grad(loss_fn, has_aux=True)
        with jax_amp() if amp else contextlib.nullcontext():
            (loss, (stats, metrics)), grads = compile_exact(vg, v["params"])(v["params"])
        steps[amp] = (loss, metrics, grads, stats)
    return steps


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def test_amp_first_step_against_jax(jax_steps):
    """Loss terms, every gradient and the BatchNorm statistics of the first
    AMP step. The pCE is a bf16 number, the mean of a bf16 sum: within one
    bf16 step of JAX's, and the total within that step too (a whole step is
    2-4x the total's AMP-to-fp32 gap, and other client ids land a step
    apart); the contrast term at rtol 5e-2; the fp32 terms (gated CRF, tree)
    at rtol 2e-3 (the port's gated CRF forms <y, y'> in fp32 from the
    widened bf16 y, JAX's in bf16). Gradients and statistics: under half of
    JAX's AMP-to-fp32 gap and under the absolute bounds, printed."""
    loss_p, m_p, grads_p, stats_p = _port_step(amp=True)
    (loss_j, m_j, grads_j, stats_j), (loss_f, _, grads_f, stats_f) = jax_steps[True], jax_steps[False]
    assert {k: str(v.dtype).replace("torch.", "") for k, v in m_p.items()} == \
        {k: str(v.dtype) for k, v in m_j.items()}
    assert abs(m_p["loss_ce"].item() - float(m_j["loss_ce"])) <= _bf16_ulp(float(m_j["loss_ce"]))
    # the contrast term is a mean of squared heatmap differences near 1e-4,
    # where each bf16 step of a heatmap element moves it by percents
    np.testing.assert_allclose(m_p["loss_lc"].item(), float(m_j["loss_lc"]), rtol=5e-2)
    for k in ("loss_crf", "loss_tree"):
        np.testing.assert_allclose(m_p[k].item(), float(m_j[k]), rtol=2e-3, err_msg=k)
    d_loss, gap_loss = abs(loss_p.item() - float(loss_j)), abs(float(loss_j) - float(loss_f))
    print(f"loss: |port - jax_amp| {d_loss:.3g}, gap {gap_loss:.3g}, share {d_loss / gap_loss:.4f}")
    assert d_loss <= _bf16_ulp(float(m_j["loss_ce"]))

    for name, p, j, f, atol in (("grads", grads_p, grads_j, grads_f, GRAD_ATOL),
                                ("stats", stats_p, stats_j, stats_f, STATS_ATOL)):
        p, j, f = _vec(p), _vec(jax.tree.map(np.asarray, j)), _vec(jax.tree.map(np.asarray, f))
        d, gap = np.linalg.norm(p - j), np.linalg.norm(j - f)
        print(f"{name}: |port - jax_amp| {d:.4g}, gap {gap:.4g}, share {d / gap:.4f} "
              f"(bound {GAP_SHARE}, absolute bound {atol})")
        assert d < GAP_SHARE * gap and d < atol, name


def test_fp32_port_step_fails_the_amp_bound(jax_steps):
    """The bound has power: the port's fp32 step (AMP ignored) sits at the
    whole gap from JAX's AMP step."""
    _, _, grads_p, _ = _port_step(amp=False)
    j, f = _vec(jax.tree.map(np.asarray, jax_steps[True][2])), _vec(jax.tree.map(np.asarray, jax_steps[False][2]))
    share = np.linalg.norm(_vec(grads_p) - j) / np.linalg.norm(j - f)
    print(f"fp32 port grads: share {share:.4f}")
    assert share > 0.9


def _vec_of_step(step):
    _, _, grads, stats = step
    return _vec(grads), _vec(stats)


def test_cpu_convolutions_round_once(jax_steps, monkeypatch):
    """The port's bf16 ``Conv`` on the CPU sums in fp32 and rounds once, as
    XLA's does (and cuDNN's bf16 kernels on the card). torch's own CPU bf16
    convolution rounds elsewhere: in ~5e-5 of its outputs it lands a bf16
    step away, and train-mode BatchNorm spreads those flips. With it, the
    port's first step would sit several times farther from JAX's AMP step,
    printed."""
    from fedicra_torch.models import blocks

    default = _vec_of_step(_port_step(amp=True))

    def native_bf16(self, x):
        if isinstance(x, tuple):  # an up block's parts, concatenated as ``Conv`` does
            x = torch.cat(x, dim=1)
        dtype = blocks.get_compute_dtype()
        if dtype is None:
            return torch.nn.Conv2d.forward(self, x)
        out = self._conv_forward(x.to(dtype), self.weight.to(dtype), None)
        return out if self.bias is None else out + self.bias.to(dtype)[:, None, None]

    monkeypatch.setattr(blocks.Conv, "forward", native_bf16)
    native = _vec_of_step(_port_step(amp=True))
    (_, _, grads_j, stats_j), (_, _, grads_f, stats_f) = jax_steps[True], jax_steps[False]
    for name, a, b, j, f in (("grads", default[0], native[0], grads_j, grads_f),
                             ("stats", default[1], native[1], stats_j, stats_f)):
        j, f = _vec(jax.tree.map(np.asarray, j)), _vec(jax.tree.map(np.asarray, f))
        gap = np.linalg.norm(j - f)
        ours, theirs = np.linalg.norm(a - j) / gap, np.linalg.norm(b - j) / gap
        print(f"{name}: share of the gap, fp32-summed convolutions {ours:.4f}, torch's CPU bf16 "
              f"convolutions {theirs:.4f}")
        assert 2 * ours < theirs, name
