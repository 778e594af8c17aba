"""The port's training forward of ResSegNetV2 against the Flax model.

Full-width ResSegNetV2 (require_stability, require_feature) at 64², batch
2+2, Flax-initialised with random biases, BN scales and running statistics
(numpy seed), carried across with ``state_dict_from_flax``. In train mode
(BatchNorm on batch statistics) the normalised outputs — ``semi``, the
stability-folded score, the descriptors — agree within 1e-5 absolute, the
encoder features within 1e-4 of their largest magnitude, and the running
statistics after one forward within 1e-5 relative. The softmaxed
stability logits agree within 2e-5: each package alone is within 1.3e-5 of
a float64 run (Flax computes the batch variance as E[x²] − E[x]², torch in
one Welford pass), and the port is held to its own float64 run at 1e-5. The last test shows that torch's own BatchNorm2d, which
moves the running variance towards the unbiased batch variance, misses
that bar by far at this size: the port's rule is the one that passes.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.models import layers as t_layers
from sfd2_torch.models.convert import state_dict_from_flax
from sfd2_torch.models.sfd2 import ResSegNetV2 as TorchResSegNetV2
from sfd2_tpu.models.sfd2 import ResSegNetV2

torch.set_num_threads(2)

R = 64


def _randomise(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "mean":
            return (rng.normal(size=a.shape) * 0.3).astype(np.float32)
        if name in ("var", "scale"):
            return (rng.random(size=a.shape) + 0.5).astype(np.float32)
        if name == "bias":
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray,
                                                                         dict(variables)))


@pytest.fixture(scope="module")
def case():
    model = ResSegNetV2(require_stability=True, require_feature=True)
    variables = _randomise(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, R, R, 3))), 0)
    x = np.random.default_rng(1).normal(size=(4, R, R, 3)).astype(np.float32)
    out_j, mutated = jax.jit(lambda v, x: model.apply(v, x, train=True, training_outputs=True,
                                                      mutable=["batch_stats"]))(variables, x)
    port = TorchResSegNetV2(require_stability=True, require_feature=True)
    port.load_state_dict(state_dict_from_flax(variables))
    port.train()
    out_t = port(torch.from_numpy(x), training_outputs=True)
    new_stats = state_dict_from_flax({"params": variables["params"],
                                      "batch_stats": mutated["batch_stats"]})
    return dict(variables=variables, x=x, out_j=out_j, out_t=out_t, port=port,
                new_stats=new_stats)


def _np(t):
    return t.detach().numpy()


def test_training_outputs_match_flax(case):
    out_j, out_t = case["out_j"], case["out_t"]
    assert out_t.semi.shape == (4, R // 8, R // 8, 65)
    assert out_t.stability_logits.shape == (4, R, R, 3)
    np.testing.assert_allclose(_np(out_t.semi), np.asarray(out_j.semi), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(out_t.stability_logits), np.asarray(out_j.stability_logits),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(_np(out_t.descriptors), np.asarray(out_j.descriptors),
                               rtol=0, atol=1e-5)
    # The folded score: score × {0.1, 0.5, 1.0}; the class argmax may flip
    # on a near-tie, so the score is held where the classes agree.
    same = _np(out_t.stability) == np.asarray(out_j.stability)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(_np(out_t.score)[same], np.asarray(out_j.score)[same],
                               rtol=0, atol=1e-5)
    assert len(out_t.features) == 2
    for ft, fj in zip(out_t.features, out_j.features):
        fj = np.asarray(fj)
        assert ft.shape == fj.shape
        np.testing.assert_allclose(_np(ft), fj, rtol=0, atol=1e-4 * np.abs(fj).max())


def test_training_outputs_match_float64(case):
    port = copy.deepcopy(case["port"]).double()
    port.load_state_dict(state_dict_from_flax(case["variables"]))  # the statistics before
    out = port(torch.from_numpy(case["x"]).double(), training_outputs=True)
    for name in ("semi", "stability_logits", "descriptors"):
        np.testing.assert_allclose(_np(getattr(case["out_t"], name)), _np(getattr(out, name)),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_inference_forward_is_unchanged(case):
    """Eval mode without training outputs: the three inference fields, the
    training ones empty, running statistics untouched."""
    port = copy.deepcopy(case["port"]).eval()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        out = port(torch.from_numpy(case["x"]))
    assert out.semi is None and out.stability_logits is None and out.features == ()
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


def _running_stats_error(port_sd, new_stats):
    """The largest error of the running statistics relative to the
    reference: elementwise for the variances, against each tensor's
    largest magnitude for the means (a mean near 0 has no relative error)."""
    worst = 0.0
    for k, ref in new_stats.items():
        if k.endswith(("running_mean", "running_var")):
            ref = ref.numpy()
            scale = np.abs(ref) if k.endswith("var") else np.abs(ref).max()
            worst = max(worst, float(np.max(np.abs(port_sd[k].numpy() - ref) / scale)))
    return worst


def test_running_statistics_match_flax(case):
    sd = case["port"].state_dict()
    assert _running_stats_error(sd, case["new_stats"]) <= 1e-5
    assert int(sd["conv1a.1.num_batches_tracked"]) == 1


def test_torch_unbiased_running_variance_fails_the_bar(case, monkeypatch):
    """The same forward with torch's native BatchNorm2d update (running
    variance towards n/(n−1) × the batch variance): its running
    statistics miss the JAX package's by far more than the bar above."""
    monkeypatch.setattr(t_layers.BatchNorm2d, "forward", torch.nn.BatchNorm2d.forward)
    port = TorchResSegNetV2(require_stability=True, require_feature=True)
    port.load_state_dict(state_dict_from_flax(case["variables"]))
    port.train()
    port(torch.from_numpy(case["x"]), training_outputs=True)
    assert _running_stats_error(port.state_dict(), case["new_stats"]) > 1e-3
