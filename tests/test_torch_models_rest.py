"""``pnet`` and ``efficient_unet`` of the port against fedicra_tpu's (CPU).

The weights are drawn by the port and carried into the flax tree by the
weight bridge (the tree's structure is ``jax.eval_shape`` of the flax init,
which holds the bridge to it). Eval mode: outputs and the gradients of a
fixed scalar at atol 2e-5. Train mode at dropout 0 and drop-connect 0:
outputs at atol 5e-5 plus rtol 5e-5, running statistics at rtol 1e-4 (atol
1e-6 for statistics near zero).

``efficient_unet``'s train mode is compared in float64 on both sides. In
fp32, flax's E[x^2] - E[x]^2 batch variance cancels in the encoder's
post-swish channels (eps 1e-3), and over 26 blocks that alone moves the /32
features by up to 3e-4 (1.8-2.7% of them past the tolerance at 64^2 to
128^2, batch 4 to 16, with the port's BatchNorm written either way); in
eval mode, on a loaded B3 checkpoint, the two agree to 7e-6 and the port
equals the torch mirror bit for bit.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedicra_tpu.models.efficientunet as jax_eff
import fedicra_tpu.models.pnet as jax_pnet
import torch_efficientnet_mirror as tm
from fedicra_torch.convert import flax_to_state_dict, state_dict_to_flax
from fedicra_torch.engine.config import TrainConfig
from fedicra_torch.engine.trainer import init_client_state
from fedicra_torch.models import efficientunet as port_eff
from fedicra_torch.models import net_factory as port_net_factory
from fedicra_torch.models.blocks import init_torch_default
from fedicra_tpu.models import net_factory
from torch_port_helpers import flat, one_torch_thread, t  # noqa: F401

MODELS = ("pnet", "efficient_unet")
# (batch, size, float64) of the train-mode comparison; eval mode runs at (2, 32)
TRAIN_SHAPE = {"pnet": (2, 32, False), "efficient_unet": (4, 64, True)}


def _leaves(out):
    for key in sorted(out):
        val = out[key]
        for i, a in enumerate(val if isinstance(val, (list, tuple)) else [val]):
            yield f"{key}[{i}]", a


@functools.lru_cache(maxsize=None)
def _flax_shapes(model_type):
    jm = net_factory(model_type, in_chns=3, class_num=3)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    return jax.eval_shape(lambda: jm.init(keys, jnp.zeros((1, 32, 32, 3)), train=False))


def _port(model_type, seed=0, no_dropout=False):
    """The port's model with weights drawn from ``seed``, and the same
    weights as flax variables; ``no_dropout`` zeroes pnet's output-block
    dropout and efficient_unet's drop-connect."""
    pm = port_net_factory(model_type, in_chns=3, class_num=3)
    if no_dropout and model_type == "pnet":
        pm.out.drop_rate = 0.0
    elif no_dropout:
        for name in pm.encoder.blocks:
            getattr(pm.encoder, name).drop_rate = 0.0
    init_torch_default(pm, torch.Generator().manual_seed(seed))
    params, stats = state_dict_to_flax(pm.state_dict())
    return pm, {"params": params, "batch_stats": stats}


def _image(b, size, seed=0):
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("model_type", MODELS)
def test_names_shapes_and_counts_equal_the_flax_tree_and_round_trip(model_type):
    pm, v = _port(model_type)
    shapes = _flax_shapes(model_type)
    for part in ("params", "batch_stats"):
        got = {k: a.shape for k, a in flat(v[part])}
        want = {k: tuple(a.shape) for k, a in flat(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes[part]))}
        assert got == want, sorted(set(got) ^ set(want))
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_flax
    sd = pm.state_dict()
    back = flax_to_state_dict(v["params"], v["batch_stats"])
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    again = state_dict_to_flax(back)
    for part, tree in zip(("params", "batch_stats"), again):
        for (k, a), (k2, b) in zip(flat(tree), flat(v[part])):
            assert k == k2 and np.array_equal(a, b), k


@pytest.mark.parametrize("model_type", MODELS)
def test_eval_mode_outputs_and_gradients(model_type):
    pm, v = _port(model_type, seed=1)
    jm = net_factory(model_type, in_chns=3, class_num=3)
    x = _image(2, 32, seed=2)
    pm.eval()
    xp = t(x, requires_grad=True)
    out_p = pm(xp)
    rng = np.random.default_rng(3)
    coeffs = [rng.normal(size=tuple(a.shape)).astype(np.float32) for _, a in _leaves(out_p)]

    @jax.jit
    def scalar_j(params, xj):
        out = jm.apply({**v, "params": params}, xj, train=False)
        return sum(jnp.mean(a * c) for (_, a), c in zip(_leaves(out), coeffs)), out

    (_, out_j), (g_params, g_x) = jax.value_and_grad(scalar_j, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    assert [n for n, _ in _leaves(out_p)] == [n for n, _ in _leaves(out_j)]
    for (name, a_p), (_, a_j) in zip(_leaves(out_p), _leaves(out_j)):
        np.testing.assert_allclose(a_p.detach().numpy(), np.asarray(a_j), atol=2e-5, rtol=0, err_msg=name)
    s_p = sum(torch.mean(a * t(c)) for (_, a), c in zip(_leaves(out_p), coeffs))
    named = list(pm.named_parameters())
    grads = torch.autograd.grad(s_p, [p for _, p in named] + [xp])
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(g_x), atol=2e-5, rtol=0, err_msg="d/dx")
    g_port = state_dict_to_flax({**dict(zip([n for n, _ in named], grads)), **dict(pm.named_buffers())})[0]
    got, want = dict(flat(g_port)), dict(flat(jax.tree.map(np.asarray, g_params)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=0, err_msg="/".join(k))


class _ZeroRateLinen:
    """flax.linen as ``pnet`` sees it, with every Dropout at rate 0."""

    def __getattr__(self, name):
        return getattr(flax.linen, name)

    @staticmethod
    def Dropout(rate, **kw):  # noqa: N802 (flax's name)
        return flax.linen.Dropout(rate=0.0, **kw)


class _NoDropConnect(jax_eff.EfficientNetEncoder):
    drop_connect: float = 0.0


@pytest.mark.parametrize("model_type", MODELS)
def test_train_mode_outputs_and_running_stats(model_type, monkeypatch):
    """pnet's output-block dropout (fixed at 0.3 in JAX) and efficient_unet's
    drop-connect are 0 on both sides."""
    monkeypatch.setattr(jax_pnet, "nn", _ZeroRateLinen())
    monkeypatch.setattr(jax_eff, "EfficientNetEncoder", _NoDropConnect)
    pm, v = _port(model_type, seed=4, no_dropout=True)
    jm = net_factory(model_type, in_chns=3, class_num=3)
    b, size, x64 = TRAIN_SHAPE[model_type]
    dtype = np.float64 if x64 else np.float32
    x = _image(b, size, seed=5).astype(dtype)
    with jax.enable_x64(x64):
        out_j, mut = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"]))(
            jax.tree.map(lambda a: jnp.asarray(a, dtype), v), jnp.asarray(x))
        out_j, mut = jax.tree.map(np.asarray, (out_j, mut))
    pm.to(torch.float64 if x64 else torch.float32).train()
    with torch.no_grad():
        out_p = pm(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    for (name, a_p), (_, a_j) in zip(_leaves(out_p), _leaves(out_j)):
        np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), atol=5e-5, rtol=5e-5, err_msg=name)
    got = dict(flat(state_dict_to_flax(pm.state_dict())[1]))
    want = dict(flat(jax.tree.map(np.asarray, mut["batch_stats"])))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg="/".join(k))


def test_drop_connect_on_jax_draws_is_bit_exact(monkeypatch):
    """One residual MBConv at drop rate 0.5 in JAX's train mode: its mask is
    recorded as JAX draws it and fed to the port's block, whose output then
    holds the dropped images' inputs bit for bit, as JAX's does, and equals
    JAX's elsewhere at the train tolerance; the application alone is
    bit-exact on the same branch."""
    draws = []
    bernoulli = jax.random.bernoulli

    def recording(key, p, shape):
        draws.append((float(p), np.asarray(bernoulli(key, p, shape))))
        return bernoulli(key, p, shape)

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    block = jax_eff.MBConv(out_ch=24, kernel=3, stride=1, expand=6, drop_rate=0.5)
    x = _image(8, 8, seed=6)[..., :1].repeat(24, -1) * np.linspace(0.5, 1.5, 24, dtype=np.float32)
    variables = block.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)
    y_j, _ = block.apply(variables, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(7)},
                         mutable=["batch_stats"])
    assert len(draws) == 1
    keep, mask = draws[0]
    assert keep == 0.5 and mask.shape == (8, 1, 1, 1) and 0 < mask.sum() < 8

    pm = port_eff.MBConv(24, 24, 3, 1, 6, drop_rate=0.5)
    pm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables["params"]),
                                          jax.tree.map(np.asarray, variables["batch_stats"])))
    pm.train()
    xp = t(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        y_p = pm(xp, t(mask).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    dropped = ~mask[:, 0, 0, 0]
    np.testing.assert_array_equal(y_p[dropped], x[dropped])
    np.testing.assert_array_equal(np.asarray(y_j)[dropped], x[dropped])
    np.testing.assert_allclose(y_p, np.asarray(y_j), atol=5e-5, rtol=5e-5)
    h = np.random.default_rng(8).normal(size=(8, 4, 4, 24)).astype(np.float32)
    want = np.asarray(jnp.asarray(h) * mask / keep)
    got = port_eff.drop_connect(t(h), t(mask), keep).numpy()
    np.testing.assert_array_equal(got, want)


def test_drop_connect_draws_one_mask_per_residual_block():
    """A train-mode forward draws (B, 1, 1, 1) masks from its generator, one
    per residual block past the first, at JAX's rate 0.2 * index / total."""
    stages, total = jax_eff._B0_STAGES, sum(jax_eff._round_repeats(r, 1.4) for r, *_ in jax_eff._B0_STAGES)
    want, idx, in_ch = [], 0, jax_eff._round_filters(32, 1.2)
    for r, _k, s, _e, c in stages:
        out_ch = jax_eff._round_filters(c, 1.2)
        for bi in range(jax_eff._round_repeats(r, 1.4)):
            if (s if bi == 0 else 1) == 1 and in_ch == out_ch and idx > 0:
                want.append(0.2 * idx / total)
            in_ch, idx = out_ch, idx + 1
    pm = port_net_factory("efficient_unet", in_chns=3, class_num=3).train()
    got = [getattr(pm.encoder, n).drop_rate for n in pm.encoder.blocks
           if getattr(pm.encoder, n).residual and getattr(pm.encoder, n).drop_rate > 0]
    assert got == pytest.approx(want, rel=0, abs=0)
    x = t(_image(2, 32))
    runs = []
    for _ in range(2):
        with torch.no_grad():
            runs.append(pm(x, generator=torch.Generator().manual_seed(3))["logits"])
    assert torch.equal(runs[0], runs[1])
    m = port_eff.draw_drop_connect(x, 0.9, torch.Generator().manual_seed(0))
    assert m.shape == (2, 1, 1, 1) and m.dtype == torch.bool


@pytest.mark.parametrize("size", [7, 8, 9, 16, 33])
@pytest.mark.parametrize("kernel", [3, 5])
def test_same_padding_is_flax_s_at_odd_and_even_sizes(size, kernel):
    """The padding equals XLA's "SAME", (0, 1) for k = 3 and (1, 2) for k = 5
    at even sizes; on integer inputs (exact in fp32) the stride-2 depthwise
    conv equals JAX's bit for bit."""
    want = jax.lax.padtype_to_pads((size, size), (kernel, kernel), (2, 2), "SAME")
    assert [port_eff.same_padding(size, kernel, 2)] * 2 == [tuple(p) for p in want]
    if size % 2 == 0:
        assert port_eff.same_padding(size, kernel, 2) == {3: (0, 1), 5: (1, 2)}[kernel]
    rng = np.random.default_rng(size * kernel)
    x = rng.integers(-4, 5, size=(2, size, size, 6)).astype(np.float32)
    w = rng.integers(-3, 4, size=(kernel, kernel, 1, 6)).astype(np.float32)
    y_j = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=6)
    layer = torch.nn.Conv2d(6, 6, kernel, stride=2, groups=6, bias=False)
    with torch.no_grad():
        layer.weight.copy_(t(w.transpose(3, 2, 0, 1)))
        y_p = port_eff.conv_same(layer, t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(y_p, np.asarray(y_j))


@pytest.fixture(scope="module")
def b3():
    return tm.make_b3_state_dict(in_chns=3, seed=3)


def test_b3_checkpoint_gives_jax_s_and_the_mirror_s_features(b3):
    """The same synthetic efficientnet-pytorch B3 state_dict, loaded by the
    port's and by JAX's ``load_pretrained_encoder``: eval-mode encoder
    features against JAX's at JAX's own mirror tolerance (2e-3 of the
    largest value), and against the torch mirror's executor at 1e-5."""
    pm = port_net_factory("efficient_unet", in_chns=3, class_num=3)
    port_eff.load_pretrained_encoder(pm, b3)
    pm.eval()
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        feats = [f.permute(0, 2, 3, 1).numpy() for f in pm.encoder(t(x).permute(0, 3, 1, 2))]
    mirror = tm.encoder_forward(b3, x)

    shapes = _flax_shapes("efficient_unet")
    loaded = jax_eff.load_pretrained_encoder(jax.tree.map(lambda s: s, dict(shapes)), b3)
    enc_vars = {"params": loaded["params"]["encoder"], "batch_stats": loaded["batch_stats"]["encoder"]}
    jax_feats = jax.jit(lambda v, x: jax_eff.EfficientNetEncoder().apply(v, x, train=False))(
        enc_vars, jnp.asarray(x))
    assert [f.shape[-1] for f in feats] == [3, 40, 32, 48, 136, 384]
    for i, (p, j, m) in enumerate(zip(feats, jax_feats, mirror)):
        scale = np.abs(m).max()
        np.testing.assert_allclose(p, m, atol=1e-5 * scale, rtol=0, err_msg=f"mirror {i}")
        np.testing.assert_allclose(p, np.asarray(j), atol=2e-3 * scale + 1e-4, rtol=0, err_msg=f"jax {i}")


def test_a_wrong_checkpoint_fails_loudly(b3):
    pm = port_net_factory("efficient_unet", in_chns=3, class_num=3)
    missing = {k: v for k, v in b3.items() if k != "_blocks.7._se_reduce.bias"}
    with pytest.raises(KeyError, match="_blocks.7._se_reduce.bias"):
        port_eff.load_pretrained_encoder(pm, missing)
    b0_stem = dict(b3, **{"_conv_stem.weight": b3["_conv_stem.weight"][:32]})
    with pytest.raises(ValueError, match="stem_conv"):
        port_eff.load_pretrained_encoder(pm, b0_stem)
    with pytest.raises(NotImplementedError, match="encoder_weights"):
        port_eff.EffiUNet(3, 3, pretrained="imagenet")


def test_init_client_state_loads_encoder_weights(b3, tmp_path):
    path = tmp_path / "efficientnet-b3.pth"
    torch.save(b3, path)
    cfg = TrainConfig.for_task("odoc", model="efficient_unet", strategy="FedAvg", procedure="pce",
                               img_size=32, batch_size=2, encoder_weights=str(path))
    pm = port_net_factory("efficient_unet", in_chns=3, class_num=3)
    state = init_client_state(pm, cfg, device="cpu")
    want = port_eff.convert_torch_encoder_state_dict(b3)
    got = {**state.params, **state.batch_stats}
    for k, v in want.items():
        assert torch.equal(got[f"encoder.{k}"], v), k
    plain = init_client_state(port_net_factory("efficient_unet", in_chns=3, class_num=3),
                              cfg.replace(encoder_weights=None), device="cpu")
    assert not torch.equal(plain.params["encoder.stem_conv.weight"], state.params["encoder.stem_conv.weight"])
    assert torch.equal(plain.params["dec0.conv1.weight"], state.params["dec0.conv1.weight"])


def test_train_and_runner_clis_pass_encoder_weights(b3, tmp_path, monkeypatch, capsys):
    """``--encoder_weights`` reaches ``init_client_state`` from the train CLI,
    and the runner passes it on (with ``--amp``) when given."""
    import fedicra_torch.federation.experiment as experiment
    from fedicra_torch.cli import runner as port_runner
    from fedicra_torch.cli import train as port_train

    path = tmp_path / "b3.pth"
    torch.save(b3, path)
    states = []
    init = experiment.init_client_state
    monkeypatch.setattr(experiment, "init_client_state",
                        lambda *a, **k: states.append(init(*a, **k)) or states[-1])
    result = port_train.main([
        "--synthetic", "--device", "cpu", "--img_class", "odoc", "--strategy", "FedAvg",
        "--procedure", "pce", "--model", "efficient_unet", "--img_size", "32", "--batch_size", "2",
        "--iters", "1", "--eval_iters", "1", "--stop_after", "1", "--limit_per_client", "2",
        "--encoder_weights", str(path), "--snapshot_root", str(tmp_path), "--exp", "eff",
    ])
    assert np.isfinite([result["final"][f"client_{c}_total_loss"] for c in range(5)]).all()
    want = port_eff.convert_torch_encoder_state_dict(b3)
    assert len(states) == 1
    for k, v in want.items():
        assert torch.equal({**states[0].params, **states[0].batch_stats}[f"encoder.{k}"], v), k
    capsys.readouterr()
    port_runner.main(["--procedure", "pce", "--exp", "x", "--model", "efficient_unet", "--amp", "1",
                      "--encoder_weights", str(path), "--debug", "1"])
    config = capsys.readouterr().out.splitlines()[0]
    assert "--amp 1" in config and f"--encoder_weights {path}" in config
