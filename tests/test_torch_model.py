"""sfd2_torch ResSegNet[V2] against the Flax model on the same weights.

Weights are Flax-initialised from a seed with BatchNorm running statistics
randomised from a numpy seed (so BN folds are not identities), carried
across with ``state_dict_from_flax``. Both models run float32 on the CPU;
score and descriptors agree to atol 2e-5 / rtol 1e-4 (float32 through ~20
conv layers summed in another order) and the stability class map — an
argmax that flips on near-ties — on ≥ 99.9 % of pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.models.convert import load_torch_state_dict, state_dict_from_flax
from sfd2_torch.models.sfd2 import ResSegNet as TorchResSegNet
from sfd2_torch.models.sfd2 import ResSegNetV2 as TorchResSegNetV2
from sfd2_torch.ops.stem import fused_stem_apply, repack_stem_params
from sfd2_tpu.models.convert import convert_ressegnet
from sfd2_tpu.models.sfd2 import ResSegNet, ResSegNetV2

# The suite runs in several worker processes on a few cores: keep each
# worker's intra-op thread pool small so workers do not oversubscribe them.
torch.set_num_threads(2)

H, W = 64, 96


def _randomise_stats(variables, seed):
    rng = np.random.default_rng(seed)

    def bn(leaf_path, a):
        a = np.asarray(a)
        if leaf_path[-1].key == "mean":
            return (rng.normal(size=a.shape) * 0.3).astype(np.float32)
        return (rng.random(size=a.shape) + 0.5).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(bn, variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return {"params": params, "batch_stats": stats}


def _flax_variables(model_cls, seed=0):
    model = model_cls(require_stability=True)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)))
    return model, _randomise_stats(variables, seed)


@pytest.fixture(scope="module")
def v2():
    model, variables = _flax_variables(ResSegNetV2)
    port = TorchResSegNetV2()
    port.load_state_dict(state_dict_from_flax(variables))
    return model, variables, port.eval()


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(1).normal(size=(2, H, W, 3)).astype(np.float32)


def _compare(out_j, out_t):
    np.testing.assert_allclose(out_t.score.numpy(), np.asarray(out_j.score),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out_t.descriptors.numpy(), np.asarray(out_j.descriptors),
                               atol=2e-5, rtol=1e-4)
    agree = (out_t.stability.numpy() == np.asarray(out_j.stability)).mean()
    assert agree >= 0.999, agree


def test_ressegnetv2_matches_flax(v2, image):
    model, variables, port = v2
    out_j = model.apply(variables, jnp.asarray(image))
    with torch.no_grad():
        out_t = port(torch.from_numpy(image))
    assert out_t.score.shape == (2, H, W)
    assert out_t.stability.shape == (2, H, W)
    assert out_t.descriptors.shape == (2, H // 4, W // 4, 128)
    _compare(out_j, out_t)


def test_forward_from_out1c_matches_flax(v2, image):
    """The fused-stem entry: the port's plain stem + forward_from_out1c
    against Flax's own full forward."""
    model, variables, port = v2
    out_j = model.apply(variables, jnp.asarray(image))
    packed = repack_stem_params(port.state_dict())
    with torch.no_grad():
        out_t = port.forward_from_out1c(fused_stem_apply(torch.from_numpy(image), packed))
    _compare(out_j, out_t)


def test_ressegnet_v1_matches_flax(image):
    model, variables = _flax_variables(ResSegNet, seed=3)
    port = TorchResSegNet()
    port.load_state_dict(state_dict_from_flax(variables))
    out_j = model.apply(variables, jnp.asarray(image))
    with torch.no_grad():
        out_t = port.eval()(torch.from_numpy(image))
    np.testing.assert_allclose(out_t.score.numpy(), np.asarray(out_j.score),
                               atol=2e-5, rtol=1e-4)
    # V1 stability is a continuous sigmoid map.
    np.testing.assert_allclose(out_t.stability.numpy(), np.asarray(out_j.stability),
                               atol=2e-5, rtol=1e-4)


def test_state_dict_round_trips_through_convert_ressegnet(v2):
    """state_dict_from_flax is the exact inverse of convert_ressegnet."""
    _, variables, port = v2
    back = convert_ressegnet({k: v.numpy() for k, v in port.state_dict().items()})
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_state_dict_keys_are_the_reference_names(v2):
    _, variables, port = v2
    sd = state_dict_from_flax(variables)
    assert list(sd) == list(port.state_dict())
    for key in ("conv1a.0.weight", "conv1a.1.running_var", "bn1b.0.running_mean",
                "conv4.2.conv2.weight", "conv4.0.bn3.bias", "convPa.3.bias",
                "convDb.weight", "ConvSta.weight"):
        assert key in sd
    assert sd["conv4.0.conv2.weight"].shape == (256, 8, 3, 3)  # groups=32, OIHW


def test_load_reference_checkpoint_strips_prefix(v2, tmp_path):
    _, _, port = v2
    wrapped = {"model": {f"module.{k}": v for k, v in port.state_dict().items()}}
    path = tmp_path / "ref.pth"
    torch.save(wrapped, path)
    sd = load_torch_state_dict(path)
    fresh = TorchResSegNetV2()
    fresh.load_state_dict(sd)  # strict: every key present and named right
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
