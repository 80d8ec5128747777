"""Shared set-up of the port's parity tests: one model in both packages.

The JAX model is initialised by ``fedicra_tpu`` and its weights are carried
into ``fedicra_torch`` through the port's weight bridge, so both hold the
same numbers. Dropout is 0 everywhere: dropout streams cannot match across
frameworks.
"""

from __future__ import annotations

import contextlib
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.convert import flax_to_state_dict, state_dict_to_flax
from fedicra_torch.engine.config import TrainConfig as PortConfig
from fedicra_torch.models import net_factory as port_net_factory
from fedicra_tpu.engine import TrainConfig
from fedicra_tpu.models import net_factory
from fedicra_tpu.models.blocks import set_compute_dtype

NO_DROPOUT = (0.0,) * 5
IMG = 32
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests on one torch thread, as autouse where imported.

    These tests issue many small ops. With pytest-xdist workers side by side,
    each with a thread per core, the workers' OpenMP teams oversubscribe the
    cores and every parallel region waits on descheduled threads: two such
    files that take ~45 s each alone took more than 400 s side by side, and
    ~50-65 s with one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(img_size=IMG, **kw):
    base = dict(
        img_size=img_size, batch_size=BATCH, strategy="FedICRA", procedure="ours",
        model="unet_lc_multihead", tree_loss_weight=0.0,
    )
    base.update(kw)
    return TrainConfig.for_task("odoc", **base), PortConfig.for_task("odoc", **base)


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def models(client_id=0, img_size=IMG, seed=0):
    """(jax_model, jax_variables, port_model) holding the same weights."""
    jm = net_factory(
        "unet_lc_multihead", in_chns=3, class_num=3, num_clients=5,
        client_id=client_id, dropout=NO_DROPOUT, dsn_dropout=0.0,
    )
    x = jnp.zeros((1, img_size, img_size, 3))
    variables = jm.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        x, train=False,
    )
    variables = to_numpy(dict(variables))
    pm = port_net_factory(
        "unet_lc_multihead", in_chns=3, class_num=3, num_clients=5,
        client_id=client_id, dropout=NO_DROPOUT, dsn_dropout=0.0,
    )
    pm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]))
    return jm, variables, pm


def batch(seed=0, b=BATCH, img_size=IMG, num_classes=3):
    """Standardised images and sparse labels (value num_classes = unlabelled).

    Zero-mean inputs keep the reference's fp32 error small: flax BatchNorm
    takes the variance as E[x^2] - E[x]^2, whose rounding grows with the
    mean of its input, and at 32^2 that alone reaches the 2e-5 tolerances.
    """
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(b, img_size, img_size, 3)).astype(np.float32)
    label = rng.integers(0, num_classes, size=(b, img_size, img_size))
    label = np.where(rng.uniform(size=label.shape) < 0.7, num_classes, label).astype(np.int32)
    return image, label


def port_stats(model):
    return state_dict_to_flax(model.state_dict())[1]


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_close(got, want, **tol):
    g, w = dict(flat(got)), dict(flat(want))
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg="/".join(k), **tol)


def t(a, **kw):
    return torch.tensor(np.array(a), **kw)


@contextlib.contextmanager
def jax_amp():
    """JAX's AMP (bf16 convolutions) within the block."""
    set_compute_dtype(jnp.bfloat16)
    try:
        yield
    finally:
        set_compute_dtype(None)


def compile_exact(fn, *args):
    """``jax.jit(fn)`` compiled to round every bf16 operation as written."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})


def output_leaves(out):
    """(name, leaf) of a model's output dict, in a fixed order; None kept."""
    for key in sorted(out):
        val = out[key]
        if isinstance(val, (list, tuple)):
            for i, a in enumerate(val):
                yield f"{key}[{i}]", a
        else:
            yield key, val


def dtype_name(a):
    if a is None:
        return None
    return str(a.dtype).replace("torch.", "")


def as_float32(a):
    """A torch or JAX array as a float32 numpy array."""
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
