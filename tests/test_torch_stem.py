"""K1's plain version (sfd2_torch/ops/stem.py) against the JAX stem.

The port's ``fused_stem_apply`` is the contract the CUDA kernel
``fused_stem_cuda`` is held to. Here it is held against the JAX package's
XLA ``fused_stem_apply`` and its Pallas kernel ``stem_pallas_apply`` run
in interpret mode, at the shapes of ``tests/test_pallas_stem.py`` with its
tolerance (atol 2e-4: float32 convolutions summed in other orders). The
kernel's own tests are in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sfd2_torch.ops.cuda_stem import StemWeights
from sfd2_torch.ops.stem import (
    fused_stem_apply,
    repack_stem_params,
    space_to_depth,
    unpack_stem_params,
)
from sfd2_tpu.ops import stem as jstem
from sfd2_tpu.ops.pallas_stem import StemWeights as PallasStemWeights
from sfd2_tpu.ops.pallas_stem import stem_pallas_apply

# The suite runs in several worker processes on a few cores: keep each
# worker's intra-op thread pool small so workers do not oversubscribe them.
torch.set_num_threads(2)


def _stem_arrays(seed):
    """Random stem weights and BN statistics (numpy, reference layouts)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(
        w1=f(64, 3, 3, 3, scale=0.2), b1=f(64, scale=0.1),
        m1=f(64, scale=0.2), v1=np.exp(f(64, scale=0.3)),
        w2=f(64, 64, 3, 3, scale=0.1), b2=f(64, scale=0.1),
        m2=f(64, scale=0.1), v2=np.exp(f(64, scale=0.2)),
    )


def _port_state(a):
    t = lambda x: torch.from_numpy(x.copy())
    return {"conv1a.0.weight": t(a["w1"]), "conv1a.0.bias": t(a["b1"]),
            "conv1a.1.running_mean": t(a["m1"]), "conv1a.1.running_var": t(a["v1"]),
            "conv1b.0.weight": t(a["w2"]), "conv1b.0.bias": t(a["b2"]),
            "bn1b.0.running_mean": t(a["m2"]), "bn1b.0.running_var": t(a["v2"])}


def _jax_packed(a):
    hwio = lambda w: np.transpose(w, (2, 3, 1, 0))
    params = {"conv1a": {"conv": {"kernel": hwio(a["w1"]), "bias": a["b1"]}},
              "conv1b": {"conv": {"kernel": hwio(a["w2"]), "bias": a["b2"]}}}
    stats = {"conv1a": {"bn": {"mean": a["m1"], "var": a["v1"]}},
             "bn1b": {"bn": {"mean": a["m2"], "var": a["v2"]}}}
    return jstem.repack_stem_params(params, stats)


@pytest.fixture(scope="module")
def weights():
    a = _stem_arrays(0)
    return repack_stem_params(_port_state(a)), _jax_packed(a), a


def test_repack_matches_jax(weights):
    packed, jpacked, _ = weights
    for got, ref in zip(packed, jpacked):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_space_to_depth_matches_jax():
    x = np.arange(2 * 6 * 8 * 3, dtype=np.float32).reshape(2, 6, 8, 3)
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jstem.space_to_depth(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(1, 64, 256, 3), (2, 96, 256, 3)])
def test_plain_stem_matches_jax_xla_stem(weights, shape):
    packed, jpacked, _ = weights
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = fused_stem_apply(torch.from_numpy(x), packed).numpy()
    ref = np.asarray(jstem.fused_stem_apply(jnp.asarray(x), jpacked, jnp.float32))
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("shape", [(1, 64, 256, 3), (2, 96, 256, 3)])
def test_plain_stem_matches_pallas_stem_interpret(weights, shape):
    packed, jpacked, _ = weights
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    got = fused_stem_apply(torch.from_numpy(x), packed).numpy()
    ref = stem_pallas_apply(jnp.asarray(x), PallasStemWeights(jpacked), dtype=jnp.float32,
                            interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4, rtol=2e-4)


def test_plain_stem_equals_unfused_convs(weights):
    """The s2d fold computes conv1a → BN → ReLU → conv1b(s2) → BN → ReLU."""
    packed, _, a = weights
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 34, 50, 3)).astype(np.float32))
    t = lambda k: torch.from_numpy(a[k])
    xc = x.permute(0, 3, 1, 2)
    h = F.conv2d(xc, t("w1"), t("b1"), padding=1)
    h = torch.relu((h - t("m1")[:, None, None]) / torch.sqrt(t("v1")[:, None, None] + 1e-5))
    h = F.conv2d(h, t("w2"), t("b2"), stride=2, padding=1)
    h = torch.relu((h - t("m2")[:, None, None]) / torch.sqrt(t("v2")[:, None, None] + 1e-5))
    np.testing.assert_allclose(fused_stem_apply(x, packed).numpy(),
                               h.permute(0, 2, 3, 1).numpy(), atol=2e-5, rtol=1e-4)


def test_unpack_recovers_folded_direct_weights(weights):
    """The kernel's direct 3×3 weights are exact copies of PackedStem entries."""
    packed, _, a = weights
    w1, b1, w2, b2 = unpack_stem_params(packed)
    inv1 = 1.0 / np.sqrt(a["v1"] + 1e-5)
    np.testing.assert_allclose(w1.numpy(), np.transpose(a["w1"], (2, 3, 1, 0)) * inv1,
                               rtol=1e-6)
    np.testing.assert_allclose(b1.numpy(), (a["b1"] - a["m1"]) * inv1, rtol=1e-5, atol=1e-6)
    inv2 = 1.0 / np.sqrt(a["v2"] + 1e-5)
    np.testing.assert_allclose(w2.numpy(), np.transpose(a["w2"], (2, 3, 1, 0)) * inv2,
                               rtol=1e-6)
    np.testing.assert_allclose(b2.numpy(), (a["b2"] - a["m2"]) * inv2, rtol=1e-5, atol=1e-6)
    sw = StemWeights(packed, "cpu")
    assert sw.w1.shape == (27, 64) and sw.w2.shape == (576, 64)
