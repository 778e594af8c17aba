"""The port's ``GroupedConvAsDense`` and ``ResBlock`` against the JAX package's.

``GroupedConvAsDense`` keeps the grouped weight [C, C/g, 3, 3]; its
``forward`` is the native groups=32 conv and its ``coarse`` method runs the
weight as a conv over C/128 coarse groups with block-diagonal kernels
(C=256: two coarse groups; C=64: one dense group, the fallback). With the
Flax ``kernel`` carried across, both forms' outputs agree with the JAX
module's within 1e-5; against ``nn.Conv2d(groups=32)`` on the same weight,
the coarse form's outputs and weight gradients agree within 1e-6 (both
forms multiply the same products; the coarse sum adds exact zeros). One
``ResBlock`` in train mode, in both forms, agrees with the JAX
``ResBlock``: outputs within 1e-5, every parameter's gradient within 1e-4
of its largest magnitude, the running statistics within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.models import layers as t_layers
from sfd2_torch.models.convert import _conv_weight, _vec
from sfd2_tpu.models import layers as j_layers

torch.set_num_threads(2)

GROUPS = 32


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _max_gap(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max())


def _use_form(form, monkeypatch):
    """ResBlock's grouped conv in `form`: ``forward`` as it is, or ``coarse``."""
    if form == "coarse":
        monkeypatch.setattr(t_layers.GroupedConvAsDense, "forward",
                            t_layers.GroupedConvAsDense.coarse)


@pytest.mark.parametrize("channels,coarse", [(256, 2), (64, 1)])
def test_coarse_groups_follow_the_jax_rule(channels, coarse):
    conv = t_layers.GroupedConvAsDense(channels, GROUPS)
    assert conv.coarse_groups == coarse
    assert conv.weight.shape == (channels, channels // GROUPS, 3, 3)
    assert [n for n, _ in conv.named_parameters()] == ["weight"]
    assert list(conv.state_dict()) == ["weight"]
    dense = conv.dense_weight().detach()
    assert dense.shape == (channels, channels // coarse, 3, 3)
    # Each output channel's kernel holds its own group's weights and zeros.
    g_in = channels // GROUPS
    for o in (0, g_in, channels // 2 - 1, channels - 1):
        start = (o // g_in) * g_in % (channels // coarse)
        np.testing.assert_array_equal(dense[o, start:start + g_in], conv.weight[o].detach())
        assert int((dense[o] != 0).sum()) == int((conv.weight[o] != 0).sum())


@pytest.mark.parametrize("form", ["coarse", "forward"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("channels", [256, 64])
def test_grouped_conv_as_dense_matches_jax(channels, stride, form):
    rng = np.random.default_rng(channels + stride)
    x = rng.normal(size=(2, 10, 12, channels)).astype(np.float32)
    jm = j_layers.GroupedConvAsDense(channels, GROUPS, stride)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(stride), x)
    ref = np.asarray(jax.jit(jm.apply)(variables, x))
    conv = t_layers.GroupedConvAsDense(channels, GROUPS, stride)
    conv.load_state_dict({"weight": _conv_weight(variables["params"]["kernel"])})
    with torch.no_grad():
        got = _nhwc(getattr(conv, form)(_nchw(x)))
    assert got.shape == ref.shape
    assert _max_gap(got, ref) <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("channels", [256, 64])
def test_coarse_form_matches_native_grouped_conv(channels, stride):
    rng = np.random.default_rng(10 * channels + stride)
    x = torch.from_numpy(rng.normal(size=(2, channels, 10, 12)).astype(np.float32))
    conv = t_layers.GroupedConvAsDense(channels, GROUPS, stride)
    native = torch.nn.Conv2d(channels, channels, 3, stride, 1, groups=GROUPS, bias=False)
    native.load_state_dict(conv.state_dict())
    out = conv.coarse(x)
    ref = native(x)
    up = torch.from_numpy(rng.normal(size=ref.shape).astype(np.float32))
    (out * up).sum().backward()
    (ref * up).sum().backward()
    ref_np, g_ref = ref.detach().numpy(), native.weight.grad.numpy()
    assert _max_gap(out.detach(), ref_np) <= 1e-6 * np.abs(ref_np).max()
    assert _max_gap(conv.weight.grad, g_ref) <= 1e-6 * np.abs(g_ref).max()
    # The module's forward is the native conv itself.
    with torch.no_grad():
        np.testing.assert_array_equal(conv(x).numpy(), ref_np)


@pytest.mark.parametrize("stride", [1, 2])
def test_grouped_form_on_a_channels_last_view(stride):
    """The trunk's activations are channels-last views of NHWC inputs:
    ``forward`` runs the conv on the view as it is (the same bits as
    ``nn.Conv2d``) and takes the weight's gradient on NCHW copies; values,
    layout and both gradients agree with the native conv's."""
    rng = np.random.default_rng(3 + stride)
    x_nhwc = torch.from_numpy(rng.normal(size=(2, 9, 11, 64)).astype(np.float32))
    conv = t_layers.GroupedConvAsDense(64, GROUPS, stride)
    x = x_nhwc.permute(0, 3, 1, 2).requires_grad_(True)
    out = conv(x)
    ref = torch.nn.Conv2d.forward(conv, x)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    assert out.stride() == ref.stride()
    up = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    gx, gw = torch.autograd.grad((out * up).sum(), (x, conv.weight))
    rx, rw = torch.autograd.grad((ref * up).sum(), (x, conv.weight))
    assert _max_gap(gx, rx) <= 1e-6 * rx.abs().max().item()
    assert _max_gap(gw, rw) <= 1e-6 * rw.abs().max().item()
    with torch.no_grad():  # inference: the conv itself
        np.testing.assert_array_equal(conv(x).numpy(), ref.detach().numpy())


def _randomised_block(channels, seed):
    rng = np.random.default_rng(seed)
    jm = j_layers.ResBlock(channels, groups=GROUPS)
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, channels)))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    for j in (1, 2, 3):
        v["params"][f"bn{j}"]["scale"] = (rng.random(channels) + 0.5).astype(np.float32)
        v["params"][f"bn{j}"]["bias"] = (rng.normal(size=channels) * 0.1).astype(np.float32)
        v["batch_stats"][f"bn{j}"]["mean"] = (rng.normal(size=channels) * 0.3).astype(np.float32)
        v["batch_stats"][f"bn{j}"]["var"] = (rng.random(channels) + 0.5).astype(np.float32)
    port = t_layers.ResBlock(channels, groups=GROUPS)
    sd = {}
    for j in (1, 2, 3):
        sd[f"conv{j}.weight"] = _conv_weight(v["params"][f"conv{j}"]["kernel"])
        sd[f"bn{j}.weight"] = _vec(v["params"][f"bn{j}"]["scale"])
        sd[f"bn{j}.bias"] = _vec(v["params"][f"bn{j}"]["bias"])
        sd[f"bn{j}.running_mean"] = _vec(v["batch_stats"][f"bn{j}"]["mean"])
        sd[f"bn{j}.running_var"] = _vec(v["batch_stats"][f"bn{j}"]["var"])
        sd[f"bn{j}.num_batches_tracked"] = torch.tensor(0)
    port.load_state_dict(sd)
    return jm, v, port


@pytest.mark.parametrize("form", ["coarse", "forward"])
def test_resblock_train_step_matches_jax(form, monkeypatch):
    channels = 256
    jm, v, port = _randomised_block(channels, seed=5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 8, channels)).astype(np.float32)
    up = rng.normal(size=x.shape).astype(np.float32)

    def loss(params, x):
        out, mutated = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
        return jnp.sum(out * up), (out, mutated["batch_stats"])

    (_, (ref, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"], x)

    _use_form(form, monkeypatch)
    port.train()
    out = port(_nchw(x))
    (out * _nchw(up)).sum().backward()
    assert _max_gap(_nhwc(out), ref) <= 1e-5 * max(1.0, np.abs(ref).max())
    for j in (1, 2, 3):
        pairs = [(getattr(port, f"conv{j}").weight.grad, _conv_weight(grads[f"conv{j}"]["kernel"])),
                 (getattr(port, f"bn{j}").weight.grad, grads[f"bn{j}"]["scale"]),
                 (getattr(port, f"bn{j}").bias.grad, grads[f"bn{j}"]["bias"])]
        for got, want in pairs:
            want = np.asarray(want)
            assert _max_gap(got, want) <= 1e-4 * np.abs(want).max(), j
        bn = getattr(port, f"bn{j}")
        for mine, theirs in ((bn.running_mean, stats[f"bn{j}"]["mean"]),
                             (bn.running_var, stats[f"bn{j}"]["var"])):
            theirs = np.asarray(theirs)
            assert _max_gap(mine, theirs) <= 1e-5 * np.abs(theirs).max(), j


@pytest.mark.parametrize("form", ["coarse", "forward"])
def test_resblock_eval_forward_matches_jax(form, monkeypatch):
    jm, v, port = _randomised_block(64, seed=7)
    x = np.random.default_rng(8).normal(size=(2, 8, 8, 64)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x))
    _use_form(form, monkeypatch)
    with torch.no_grad():
        got = _nhwc(port.eval()(_nchw(x)))
    assert _max_gap(got, ref) <= 1e-5 * max(1.0, np.abs(ref).max())


def test_coarse_form_trains_after_inference():
    """The scatter index is a buffer made with the module: a first call
    under ``inference_mode`` leaves nothing that a later training step of
    the coarse form would have to save for backward."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(1, 256, 6, 6)).astype(np.float32))
    conv = t_layers.GroupedConvAsDense(256, GROUPS)
    with torch.inference_mode():
        first = conv.coarse(x)
    out = conv.coarse(x)
    out.sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), first.numpy())
    assert conv.weight.grad.shape == conv.weight.shape
    assert conv.to(torch.float64)._index.dtype == torch.int64
