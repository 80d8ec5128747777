"""Mixed precision: the dtype of every output of every model type under the
bf16 compute dtype equals JAX's (``jax.eval_shape`` after
``set_compute_dtype(jnp.bfloat16)``), in train and eval mode (CPU).

JAX's AMP is not ``torch.autocast``: ``Conv`` computes in bf16, BatchNorm
casts its input to fp32, the DSN heads and every bare ``nn.Conv`` stay fp32
(``pnet`` is fp32 throughout), so logits and PCS heatmaps are bf16 and
features, decoder stages and DSN aux are fp32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.models import LC_MODELS
from fedicra_torch.models import net_factory as port_net_factory
from fedicra_torch.models.blocks import compute_dtype
from fedicra_tpu.models import net_factory
from torch_port_helpers import IMG, dtype_name, jax_amp, one_torch_thread, output_leaves, t  # noqa: F401

MODEL_TYPES = (
    "unet", "unet_cct", "unet_cct_3h", "unet_ds", "efficient_unet", "pnet", "unet_head",
    "unet_multihead", "unet_lc", "unet_lc_multihead", "unet_lc_multihead_two",
)


@functools.lru_cache(maxsize=None)
def _jax_model(model_type):
    """The JAX model and its variables' shapes (``jax.eval_shape`` of init)."""
    jm = net_factory(model_type, in_chns=3, class_num=3)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    return jm, jax.eval_shape(lambda: jm.init(keys, jnp.zeros((1, IMG, IMG, 3)), train=False))


def _jax_dtypes(model_type, train):
    jm, variables = _jax_model(model_type)
    x = jax.ShapeDtypeStruct((2, IMG, IMG, 3), jnp.float32)
    kw = {"emb_idx": jnp.full((2,), 1, jnp.int32)} if model_type in LC_MODELS else {}
    with jax_amp():
        if train:
            rngs = {"dropout": jax.random.PRNGKey(2), "perturb": jax.random.PRNGKey(3)}
            out = jax.eval_shape(lambda v, x: jm.apply(
                v, x, train=True, rngs=rngs, mutable=["batch_stats"], **kw)[0], variables, x)
        else:
            out = jax.eval_shape(lambda v, x: jm.apply(v, x, train=False, **kw), variables, x)
    return [(n, dtype_name(a)) for n, a in output_leaves(out)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_dtype_map_equals_jax(model_type, train):
    """Every output's dtype under the bf16 context, as ``jax.eval_shape`` of
    the JAX model gives it: bf16 logits (and PCS heatmaps), fp32 features,
    decoder stages and DSN aux; ``pnet`` all fp32."""
    want = _jax_dtypes(model_type, train)
    pm = port_net_factory(model_type, in_chns=3, class_num=3).train(train)
    x = t(np.random.default_rng(0).normal(size=(2, IMG, IMG, 3)).astype(np.float32))
    emb = torch.full((2,), 1) if model_type in LC_MODELS else None
    with torch.no_grad(), compute_dtype(torch.bfloat16):
        out = pm(x, emb_idx=emb, generator=torch.Generator().manual_seed(0))
    assert [(n, dtype_name(a)) for n, a in output_leaves(out)] == want
    assert ("logits", "float32" if model_type == "pnet" else "bfloat16") in want
    # outside the context the port is fp32 throughout
    with torch.no_grad():
        out = pm(x, emb_idx=emb, generator=torch.Generator().manual_seed(0))
    assert {dtype_name(a) for _, a in output_leaves(out)} <= {"float32", None}
