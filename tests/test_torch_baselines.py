"""The port's baseline networks and their converters against the JAX package's.

Each network is Flax-initialised from a seed, with every bias, BN scale
and BN running statistic randomised from a numpy seed (so no mapping can
hide behind a zero or an identity), carried across by the port's
``*_from_flax`` converter, and run on the same numpy input in float32 on
the CPU. Tolerances: 1e-5 absolute on L2-normalised outputs and on
scores/probabilities; 1e-4 of the map's largest magnitude on raw feature
maps (float32 through up to ~40 layers summed in another order); the
D2-Net hard-detection masks equal (ties are part of the mask, so a set
comparison). Converters: the JAX converter applied to the port's
state_dict, then the port's flax→torch function, gives back the same
tensors exactly; the port's reference converters load state_dicts in the
reference checkpoints' key layouts with ``strict=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.models import baselines as tb
from sfd2_torch.models import convert_baselines as tcb
from sfd2_torch.models import r2d2 as tr2
from sfd2_torch.models import retrieval as tret
from sfd2_torch.models import superpoint as tsp
from sfd2_tpu.models import baselines as jb
from sfd2_tpu.models import convert_baselines as jcb
from sfd2_tpu.models import r2d2 as jr2
from sfd2_tpu.models import retrieval as jret
from sfd2_tpu.models import superpoint as jsp

torch.set_num_threads(2)


def _randomise(variables, seed):
    """Random biases, BN scales and running statistics (numpy seed)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "mean":
            return (rng.normal(size=a.shape) * 0.3).astype(np.float32)
        if name == "var":
            return (rng.random(size=a.shape) + 0.5).astype(np.float32)
        if name == "scale":
            return (rng.random(size=a.shape) + 0.5).astype(np.float32)
        if name == "bias":
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return a

    host = jax.tree_util.tree_map(np.asarray, dict(variables))
    return jax.tree_util.tree_map_with_path(leaf, host)


def _init(model, shape, seed=0):
    # A jitted init compiles once, where an eager one compiles op by op.
    return _randomise(jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros(shape)), seed)


def _apply(model, v, x):
    return jax.jit(model.apply)(v, jnp.asarray(x))


def _port(module, sd):
    module.load_state_dict(sd)  # strict
    return module.eval()


def _run(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x))


def _image(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close_unit(got, ref):
    np.testing.assert_allclose(_t(got), np.asarray(ref), rtol=0, atol=1e-5)


def _close_raw(got, ref):
    ref = np.asarray(ref)
    assert _t(got).shape == ref.shape
    np.testing.assert_allclose(_t(got), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------


def test_superpoint_matches_jax():
    x = np.random.default_rng(1).random((2, 64, 96, 1)).astype(np.float32)
    model = jsp.SuperPoint()
    v = _init(model, (1, 64, 96, 1))
    ref = _apply(model, v, x)
    got = _run(_port(tsp.SuperPoint(), tcb.superpoint_from_flax(v)), x)
    assert got["scores"].shape == (2, 64, 96) and got["descs"].shape == (2, 8, 12, 256)
    for k in ("scores", "semi_norm", "semi", "descs"):
        _close_unit(got[k], ref[k])


@pytest.mark.parametrize("net", ["quad_l2net", "l2net"])
def test_r2d2_nets_match_jax(net):
    x = _image((1, 48, 64, 3))
    if net == "quad_l2net":
        model, port = jr2.QuadL2NetConfCFS(dim=32), tr2.QuadL2NetConfCFS(dim=32)
        v = _init(model, (1, 48, 64, 3))
        sd = tcb.quad_l2net_from_flax(v, dim=32)
    else:
        model, port = jr2.L2Net(dim=32), tr2.L2Net(dim=32)
        v = _init(model, (1, 48, 64, 3))
        sd = tcb.l2net_from_flax(v, dim=32)
    ref = _apply(model, v, x)
    got = _run(_port(port, sd), x)
    assert set(got) == set(ref)
    assert got["descriptors"].shape == (1, 48, 64, 32)  # full resolution
    for k in ref:
        _close_unit(got[k], ref[k])


def test_d2net_dense_and_hard_detect_match_jax():
    x = _image((1, 32, 40, 3)) * 60.0  # caffe-scale input
    model = jb.D2NetDense(use_relu=True)
    v = _init(model, (1, 32, 40, 3))
    ref = _apply(model, v, x)
    got = _run(_port(tb.D2NetDense(use_relu=True), tcb.d2net_from_flax(v)), x)
    assert got.shape == ref.shape == (1, 7, 9, 512)  # the AvgPool2d(2, 1) shrink-by-1
    _close_raw(got, ref)
    # Hard detection on the JAX features: the same mask and scores.
    fired_j, score_j = jb.d2net_hard_detect(ref)
    fired_t, score_t = tb.d2net_hard_detect(torch.from_numpy(np.array(ref)))
    np.testing.assert_array_equal(fired_t.numpy(), np.asarray(fired_j))
    np.testing.assert_array_equal(score_t.numpy(), np.asarray(score_j))


@pytest.mark.parametrize("case", ["random", "analytic"])
def test_d2net_hard_detect_matches_jax(case):
    if case == "random":
        # ReLU-like features quantised to a few levels: ties on the channel
        # max and on the 3×3 local max are frequent.
        rng = np.random.default_rng(5)
        f = np.maximum(np.round(rng.normal(size=(2, 20, 24, 16)) * 2) / 2, 0).astype(np.float32)
    else:
        f = np.zeros((1, 24, 24, 4), np.float32)
        f[0, 6, 6, 2] = 1.0  # an isolated blob fires at its centre
        f[0, 6, 5, 2] = f[0, 6, 7, 2] = f[0, 5, 6, 2] = f[0, 7, 6, 2] = 0.5
        f[0, 16, 4:20, 1] = 1.0  # a straight ridge is edge-like
    fired_j, score_j = jb.d2net_hard_detect(jnp.asarray(f))
    fired_t, score_t = tb.d2net_hard_detect(torch.from_numpy(f))
    np.testing.assert_array_equal(fired_t.numpy(), np.asarray(fired_j))
    np.testing.assert_array_equal(score_t.numpy(), np.asarray(score_j))
    if case == "analytic":
        assert fired_t[0, 6, 6] and not fired_t[0, 16, 6:18].any()
    else:
        assert 0 < fired_t.sum() < fired_t.numel()


def test_caps_resunet_matches_jax():
    x = _image((1, 64, 64, 3))
    model = jb.CapsResUNet(layers=(1, 1, 1))
    v = _init(model, (1, 64, 64, 3))
    ref_c, ref_f = _apply(model, v, x)
    got_c, got_f = _run(_port(tb.CapsResUNet(layers=(1, 1, 1)), tcb.caps_from_flax(v)), x)
    assert got_c.shape == (1, 4, 4, 128) and got_f.shape == (1, 16, 16, 128)
    _close_raw(got_c, ref_c)
    _close_raw(got_f, ref_f)


def test_caps_sample_descriptors_match_jax():
    rng = np.random.default_rng(2)
    coarse = rng.normal(size=(6, 8, 16)).astype(np.float32)
    fine = rng.normal(size=(12, 16, 8)).astype(np.float32)
    # Inside, on the edges and beyond them: the "edge" (clamped) taps count.
    xy = np.concatenate([np.stack([rng.uniform(0, 63, 30), rng.uniform(0, 47, 30)], -1),
                         [[0, 0], [63, 47], [-2, 10], [66, 50]]]).astype(np.float32)
    ref = jb.caps_sample_descriptors(jnp.asarray(coarse), jnp.asarray(fine), jnp.asarray(xy),
                                     (48, 64))
    got = tb.caps_sample_descriptors(torch.from_numpy(coarse), torch.from_numpy(fine),
                                     torch.from_numpy(xy), (48, 64))
    assert got.shape == (len(xy), 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_spd2l2net_matches_jax():
    x = _image((1, 32, 32, 3))
    model = jb.SPD2L2Net(outdim=128)
    v = _init(model, (1, 32, 32, 3))
    ref_s, ref_d = _apply(model, v, x)
    got_s, got_d = _run(_port(tb.SPD2L2Net(outdim=128), tcb.spd2l2net_from_flax(v)), x)
    assert got_s.shape == (1, 32, 32) and got_d.shape == (1, 32, 32, 128)
    _close_unit(got_s, ref_s)
    _close_unit(got_d, ref_d)


@pytest.mark.parametrize("require_feature", [False, True])
def test_l2segnetnb_matches_jax(require_feature):
    x = _image((1, 32, 32, 3))
    model = jb.L2SegNetNB(outdim=128, require_feature=require_feature)
    v = _init(model, (1, 32, 32, 3))
    ref = _apply(model, v, x)
    port = tb.L2SegNetNB(outdim=128, require_feature=require_feature)
    got = _run(_port(port, tcb.l2segnetnb_from_flax(v)), x)
    assert len(got) == len(ref) == (3 if require_feature else 2)
    _close_unit(got[0], ref[0])
    _close_unit(got[1], ref[1])
    if require_feature:
        for g, r in zip(got[2], ref[2]):
            _close_raw(g, r)


def test_resnet_gem_matches_jax():
    x = _image((2, 64, 64, 3))
    model = jret.ResNetGeM(depths=(1, 1, 1, 1))
    v = _init(model, (1, 64, 64, 3))
    ref = _apply(model, v, x)
    got = _run(_port(tret.ResNetGeM(depths=(1, 1, 1, 1)), tcb.resnet_gem_from_flax(v)), x)
    assert got.shape == (2, 2048)
    _close_unit(got, ref)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)


def test_resnet_gem_bf16_trunk_keeps_a_float32_tail():
    port = tret.ResNetGeM(depths=(1, 1, 1, 1), dtype=torch.bfloat16)
    assert port.conv1.weight.dtype == torch.bfloat16
    assert port.whiten.weight.dtype == torch.float32
    out = _run(port.eval(), _image((1, 64, 64, 3)))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_gem_pool_and_pca_whiten_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 7, 16)).astype(np.float32)
    _close_unit(tret.gem_pool(torch.from_numpy(x)), jret.gem_pool(jnp.asarray(x)))
    _close_unit(tret.gem_pool(torch.from_numpy(x).to(torch.bfloat16)),
                jret.gem_pool(jnp.asarray(x, jnp.bfloat16)))
    desc = rng.normal(size=(6, 16))
    mean, comps = desc.mean(0), np.linalg.svd(desc - desc.mean(0))[2][:4]
    var = rng.random(4) + 0.1
    for kw in ({}, {"whitenv": 3, "whitenp": 0.5, "whitenm": 2.0}):
        got = tret.pca_whiten(desc, mean, comps, var, **kw)
        np.testing.assert_array_equal(got, jret.pca_whiten(desc, mean, comps, var, **kw))
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-12)


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------


def _filled(module, seed):
    """A port module's state_dict with every float entry random."""
    gen = torch.Generator().manual_seed(seed)
    return {k: (torch.rand(v.shape, generator=gen) + 0.5 if v.is_floating_point() else v)
            for k, v in module.state_dict().items()}


ROUND_TRIPS = {
    "superpoint": (tsp.SuperPoint, jsp.convert_superpoint, tcb.superpoint_from_flax),
    "d2net": (tb.D2NetDense, jcb.convert_d2net, tcb.d2net_from_flax),
    "caps": (tb.CapsResUNet, jcb.convert_caps, tcb.caps_from_flax),
    "spd2l2net": (tb.SPD2L2Net, jcb.convert_spd2l2net, tcb.spd2l2net_from_flax),
    "l2segnetnb": (tb.L2SegNetNB, jcb.convert_l2segnetnb, tcb.l2segnetnb_from_flax),
    "dir": (lambda: tret.ResNetGeM(depths=(2, 1, 3, 1)),
            lambda sd: jret.convert_dir_resnet(sd, depths=(2, 1, 3, 1)),
            tcb.resnet_gem_from_flax),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_jax_converter_then_port_gives_back_the_state_dict(name):
    make, jconvert, from_flax = ROUND_TRIPS[name]
    sd = _filled(make(), seed=7)
    back = from_flax(jconvert(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype, k
        assert torch.equal(back[k], v), k


def _prefixed(prefix):
    return lambda sd: {f"{prefix}{k}": v for k, v in sd.items()}


def _without_counters(sd):
    return {f"module.{k}": v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


# (port module, port converter, the port's names → the reference layout)
REFERENCE_LAYOUTS = {
    "superpoint_v1": (tsp.SuperPoint, tsp.convert_superpoint, _prefixed("")),
    "r2d2 module.": (tr2.QuadL2NetConfCFS, tr2.convert_r2d2, _prefixed("module.")),
    "d2net model dump": (tb.D2NetDense, tcb.convert_d2net,
                         _prefixed("dense_feature_extraction.")),
    "d2net sequential": (tb.D2NetDense, tcb.convert_d2net, _prefixed("")),
    "caps net.": (tb.CapsResUNet, tcb.convert_caps, _prefixed("net.")),
    "caps net.net.": (tb.CapsResUNet, tcb.convert_caps, _prefixed("net.net.")),
    "spd2l2net": (tb.SPD2L2Net, tcb.convert_spd2l2net, _prefixed("")),
    "l2segnetnb": (tb.L2SegNetNB, tcb.convert_l2segnetnb, _prefixed("module.")),
    "dir": (lambda: tret.ResNetGeM(depths=(1, 2, 1, 1)), tret.convert_dir_resnet,
            _without_counters),
}


@pytest.mark.parametrize("layout", sorted(REFERENCE_LAYOUTS))
def test_reference_checkpoints_load_strictly(layout):
    make, convert, to_reference = REFERENCE_LAYOUTS[layout]
    want = _filled(make(), seed=len(layout))
    got = convert(to_reference(want))
    make().load_state_dict(got, strict=True)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("name", ["d2net", "caps", "spd2l2net", "l2segnetnb", "dir"])
def test_reference_converters_agree_with_jax(name):
    """The port's reference converter equals the JAX converter carried
    across by the port's flax→torch function."""
    make, jconvert, from_flax = ROUND_TRIPS[name]
    port_convert = {"d2net": tcb.convert_d2net, "caps": tcb.convert_caps,
                    "spd2l2net": tcb.convert_spd2l2net, "l2segnetnb": tcb.convert_l2segnetnb,
                    "dir": tret.convert_dir_resnet}[name]
    sd = _filled(make(), seed=11)
    prefix = {"d2net": "dense_feature_extraction.", "caps": "net."}.get(name, "")
    ref_layout = {f"{prefix}{k}": v for k, v in sd.items()}
    got, ref = port_convert(ref_layout), from_flax(jconvert(ref_layout))
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_dir_converter_raises_on_a_missing_key():
    sd = _filled(tret.ResNetGeM(depths=(1, 1, 1, 1)), 8)
    del sd["layer2.0.downsample.1.running_var"]
    with pytest.raises(KeyError):
        tret.convert_dir_resnet(sd, depths=(1, 1, 1, 1))
