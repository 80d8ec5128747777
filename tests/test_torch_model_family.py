"""Every U-Net type of the port against fedicra_tpu's, on the same weights (CPU).

Each model is initialised by flax and carried into the port through the
weight bridge. Eval mode: every output and the gradient of a fixed scalar of
the outputs, at atol 2e-5. Train mode at dropout 0 (encoder and DSN heads):
outputs at atol 5e-5 and rtol 5e-5, running statistics at rtol 1e-4 (atol
1e-6 for statistics near zero). The relative term is for the bottleneck's
features, of magnitude up to ~1.5 after a BatchNorm over 8 values a channel,
where flax's E[x^2] - E[x]^2 variance alone errs by ~4e-5 of the value.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedicra_tpu.models.unet as jax_unet
from fedicra_torch.convert import flax_to_state_dict, state_dict_to_flax
from fedicra_torch.models import LC_MODELS, net_factory as port_net_factory
from fedicra_torch.models import unet as port_unet
from fedicra_tpu.models import net_factory
from fedicra_tpu.models.factory import LC_MODELS as JAX_LC_MODELS
from torch_port_helpers import NO_DROPOUT, flat, one_torch_thread, t  # noqa: F401

IMG = 32
UNET_TYPES = (
    "unet", "unet_cct", "unet_cct_3h", "unet_ds", "unet_head", "unet_multihead",
    "unet_lc", "unet_lc_multihead", "unet_lc_multihead_two",
)
SHAPES = ((1, 2), (3, 3))  # (in_chns, classes)
CASES = [(m, c, k) for m in UNET_TYPES for c, k in SHAPES]
CASE_IDS = [f"{m}-{c}ch-{k}cls" for m, c, k in CASES]


@functools.lru_cache(maxsize=None)
def _jax_variables(model_type, in_chns, classes):
    jm = net_factory(model_type, in_chns=in_chns, class_num=classes)
    v = jm.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        jnp.zeros((1, IMG, IMG, in_chns)), train=False,
    )
    return jm, jax.tree.map(np.asarray, dict(v))


def _pair(model_type, in_chns, classes):
    jm, v = _jax_variables(model_type, in_chns, classes)
    pm = port_net_factory(model_type, in_chns=in_chns, class_num=classes)
    pm.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    return jm, v, pm


def _image(in_chns, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, IMG, IMG, in_chns)).astype(np.float32)


def _leaves(out):
    """(name, array) for every output array, in a fixed order."""
    for key in sorted(out):
        val = out[key]
        if isinstance(val, (list, tuple)):
            for i, a in enumerate(val):
                if a is not None:
                    yield f"{key}[{i}]", a
        else:
            yield key, val


def _close(got, want, atol, what="", rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol, err_msg=what)


def _to_flax_grads(model, grads):
    """Port gradients by parameter name -> the flax params tree."""
    buffers = {n: b for n, b in model.named_buffers()}
    return state_dict_to_flax({**grads, **buffers})[0]


@pytest.mark.parametrize("model_type,in_chns,classes", CASES, ids=CASE_IDS)
def test_bridge_matches_the_flax_tree_and_round_trips(model_type, in_chns, classes):
    _, v, pm = _pair(model_type, in_chns, classes)
    n_jax = sum(a.size for a in jax.tree.leaves(v["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_jax
    params, stats = state_dict_to_flax(pm.state_dict())
    for got, want in ((params, v["params"]), (stats, v["batch_stats"])):
        g, w = dict(flat(got)), dict(flat(want))
        assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
        for k in w:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(k))
    assert flax_to_state_dict(params, stats).keys() == pm.state_dict().keys()


def test_unet_parameter_count_is_the_references():
    """1.813M for unet with 1 channel and 2 classes (the reference's count)."""
    _, v, pm = _pair("unet", 1, 2)
    assert sum(a.size for a in jax.tree.leaves(v["params"])) == 1813474
    assert sum(p.numel() for p in pm.parameters()) == 1813474


@pytest.mark.parametrize("model_type,in_chns,classes", CASES, ids=CASE_IDS)
def test_eval_mode_outputs_and_gradients(model_type, in_chns, classes):
    jm, v, pm = _pair(model_type, in_chns, classes)
    x = _image(in_chns, seed=len(model_type))
    emb = 2 if model_type in LC_MODELS else None
    pm.eval()
    xp = t(x, requires_grad=True)
    out_p = pm(xp, emb_idx=emb)

    # a fixed scalar of every output: sum_k mean(out_k * c_k); JAX gives its
    # outputs and gradients from one forward and backward
    rng = np.random.default_rng(11)
    coeffs = [rng.normal(size=tuple(a.shape)).astype(np.float32) for _, a in _leaves(out_p)]

    def scalar_j(params, xj):
        out = jm.apply({**v, "params": params}, xj, train=False, emb_idx=emb)
        return sum(jnp.mean(a * c) for (_, a), c in zip(_leaves(out), coeffs)), out

    (_, out_j), (g_params_j, g_x_j) = jax.value_and_grad(
        scalar_j, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    assert [n for n, _ in _leaves(out_p)] == [n for n, _ in _leaves(out_j)]
    for (name, a_p), (_, a_j) in zip(_leaves(out_p), _leaves(out_j)):
        _close(a_p.detach().numpy(), a_j, 2e-5, name)

    s_p = sum(torch.mean(a * t(c)) for (_, a), c in zip(_leaves(out_p), coeffs))
    named = list(pm.named_parameters())
    grads = torch.autograd.grad(s_p, [p for _, p in named] + [xp], allow_unused=True)
    _close(grads[-1].numpy(), g_x_j, 2e-5, "d/dx")
    g_port = {n: (torch.zeros_like(p) if g is None else g) for (n, p), g in zip(named, grads)}
    g, w = dict(flat(_to_flax_grads(pm, g_port))), dict(flat(g_params_j))
    assert g.keys() == w.keys()
    for k in w:
        _close(g[k], w[k], 2e-5, "/".join(k))


class _NoDSNDropout(jax_unet.DecoderMultiHead):
    dsn_dropout: float = 0.0


@pytest.mark.parametrize("model_type", ["unet", "unet_lc", "unet_lc_multihead_two"])
def test_train_mode_outputs_and_running_stats(model_type, monkeypatch):
    """Encoder and DSN dropout at 0 on both sides: JAX's LC decoders take the
    DSN rate from ``DecoderMultiHead``'s default, patched here to 0."""
    monkeypatch.setattr(jax_unet, "DecoderMultiHead", _NoDSNDropout)
    in_chns, classes = 3, 3
    jm = net_factory(model_type, in_chns=in_chns, class_num=classes, dropout=NO_DROPOUT)
    v = jax.tree.map(np.asarray, dict(jm.init(
        {"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
        jnp.zeros((1, IMG, IMG, in_chns)), train=False,
    )))
    if model_type == "unet":
        pm = port_net_factory(model_type, in_chns=in_chns, class_num=classes, dropout=NO_DROPOUT)
    else:
        cls = {"unet_lc": port_unet.UNetLC, "unet_lc_multihead_two": port_unet.UNetLCMultiHeadTwo}
        pm = cls[model_type](in_chns, classes, num_clients=5, dropout=NO_DROPOUT, dsn_dropout=0.0)
    pm.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    x = _image(in_chns, seed=21)
    kw = {"emb_idx": jnp.full((2,), 3, jnp.int32)} if model_type in JAX_LC_MODELS else {}
    out_j, mut = jm.apply(
        v, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"], **kw,
    )
    pm.train()
    with torch.no_grad():
        out_p = pm(t(x), emb_idx=torch.full((2,), 3) if kw else None)
    assert [n for n, _ in _leaves(out_p)] == [n for n, _ in _leaves(out_j)]
    for (name, a_p), (_, a_j) in zip(_leaves(out_p), _leaves(out_j)):
        _close(a_p.numpy(), a_j, 5e-5, name, rtol=5e-5)
    got = dict(flat(state_dict_to_flax(pm.state_dict())[1]))
    want = dict(flat(mut["batch_stats"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg="/".join(k))


def _nhwc_features(seed=0, shape=(2, 8, 8, 6)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(a):
    return t(np.transpose(a, (0, 3, 1, 2)))


def _to_nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("perturbation", ["channel_dropout", "feature_noise", "feature_dropout"])
def test_cct_perturbations_on_jax_draws(perturbation):
    key = jax.random.PRNGKey(17)
    x = _nhwc_features(seed=1)
    if perturbation == "channel_dropout":
        keep = jax.random.bernoulli(key, 0.5, (x.shape[0], 1, 1, x.shape[-1]))
        got = port_unet.channel_dropout(_nchw(x), _nchw(np.asarray(keep)))
        want = jax_unet.channel_dropout(key, jnp.asarray(x))
    elif perturbation == "feature_noise":
        noise = jax.random.uniform(key, x.shape[1:], minval=-0.3, maxval=0.3)
        got = port_unet.feature_noise(_nchw(x), t(np.transpose(np.asarray(noise), (2, 0, 1))))
        want = jax_unet.feature_noise(key, jnp.asarray(x))
    else:
        scale = jax.random.uniform(key, (), minval=0.7, maxval=0.9)
        got = port_unet.feature_dropout(_nchw(x), t(np.asarray(scale)))
        want = jax_unet.feature_dropout(key, jnp.asarray(x))
        assert 0 < float((np.asarray(want) == 0).mean()) < 1  # some pixels dropped, not all
    np.testing.assert_array_equal(_to_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("perturbation", ["channel_dropout", "feature_noise", "feature_dropout"])
def test_cct_draws_follow_the_generator(perturbation):
    """A draw is a function of the generator's state, with JAX's ranges."""
    x = _nchw(_nhwc_features(seed=2))
    draw = {
        "channel_dropout": lambda g: port_unet.draw_channel_dropout(x, g),
        "feature_noise": lambda g: port_unet.draw_feature_noise(x, g),
        "feature_dropout": lambda g: port_unet.draw_feature_dropout(g),
    }[perturbation]
    a, b = draw(torch.Generator().manual_seed(4)), draw(torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    if perturbation == "channel_dropout":
        assert a.shape == (2, 6, 1, 1) and a.dtype == torch.bool
    elif perturbation == "feature_noise":
        assert a.shape == (6, 8, 8) and -0.3 <= a.min() and a.max() < 0.3
    else:
        assert a.shape == () and 0.7 <= a < 0.9


def test_cct3h_train_mode_moves_aux_decoder2_statistics():
    pm = port_net_factory("unet_cct_3h", in_chns=3, class_num=3)
    before = {k: v.clone() for k, v in pm.state_dict().items() if "running" in k}
    pm.train()
    with torch.no_grad():
        out = pm(t(_image(3, seed=4)), generator=torch.Generator().manual_seed(0))
    assert len(out["aux"]) == 2
    moved = {k for k, v in pm.state_dict().items() if "running" in k and not torch.equal(v, before[k])}
    for part in ("encoder.", "main_decoder.", "aux_decoder1.", "aux_decoder2."):
        assert any(k.startswith(part) for k in moved), part


@pytest.mark.parametrize("hw,out_hw", [((4, 4), (32, 32)), ((8, 8), (32, 32)), ((5, 7), (32, 24))])
def test_interp_nearest_is_bit_exact(hw, out_hw):
    x = np.random.default_rng(3).normal(size=(2, *hw, 3)).astype(np.float32)
    want = jax_unet._interp_nearest(jnp.asarray(x), out_hw)
    got = port_unet._interp_nearest(_nchw(x), out_hw)
    np.testing.assert_array_equal(_to_nhwc(got), np.asarray(want))


def test_jax_cct_cannot_train_and_the_port_takes_a_pce_step():
    """Reference fault: JAX's CCT train-mode forward asks for a "perturb" RNG
    that no objective passes. The port draws from the forward's generator."""
    from fedicra_torch.engine.config import TrainConfig as PortConfig
    from fedicra_torch.engine.trainer import init_client_state, make_round_fn
    from fedicra_tpu.engine import TrainConfig
    from fedicra_tpu.engine.objective import pce_loss

    kw = dict(img_size=IMG, batch_size=2, strategy="FedAvg", procedure="pce",
              model="unet_cct", iters=1)
    cfg_j, cfg_p = TrainConfig.for_task("odoc", **kw), PortConfig.for_task("odoc", **kw)
    jm, v = _jax_variables("unet_cct", 3, 3)
    x = _image(3, seed=6)
    labels = np.random.default_rng(6).integers(0, 4, size=(2, IMG, IMG)).astype(np.int32)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}
    with pytest.raises(flax.errors.InvalidRngError, match="perturb"):
        pce_loss(jm, v["params"], v["batch_stats"], jax.random.PRNGKey(0), batch, 0, cfg_j)

    pm = port_net_factory("unet_cct", in_chns=3, class_num=3)
    state = init_client_state(pm, cfg_p, device="cpu")
    new, metrics = make_round_fn(pm, cfg_p, device="cpu")(
        state, {"image": x[None], "label": labels[None]}, 0
    )
    assert torch.isfinite(metrics["total_loss"]).all()
    assert not torch.equal(new.params["main_decoder.out_conv.weight"],
                           state.params["main_decoder.out_conv.weight"])
    assert new.current_iter == 1


@pytest.mark.parametrize("model_type", ["unet", "unet_ds", "unet_cct"])
def test_non_lc_models_ignore_emb_idx(model_type):
    pm = port_net_factory(model_type, in_chns=3, class_num=3).eval()
    x = t(_image(3, seed=8))
    with torch.no_grad():
        a, b = pm(x)["logits"], pm(x, emb_idx=torch.full((2,), 4))["logits"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("model_type", ["pnet", "efficient_unet"])
def test_unported_types_name_the_roadmap(model_type):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_net_factory(model_type)
