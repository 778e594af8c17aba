"""The port's loss modules against the JAX package's, on the CPU.

Inputs come from numpy seeds. ``quantize``, ``compute_ap`` and the
semantics tables agree within 1e-6; every term and variant of
``seg_loss``, its sampler fed the positions ``jax.random`` draws for the
same key (``jax_positions``), agrees within 1e-5 relative. The gt score maps are continuous random values, so
seg_desc's top-k meets no exact tie; ``test_topk_ties_go_to_the_lower_index``
holds the port's tie rule (a stable descending sort) against
``jax.lax.top_k`` on a map full of ties.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.training import ap_loss as t_ap
from sfd2_torch.training import losses as t_losses
from sfd2_torch.training import sampler as t_sampler
from sfd2_torch.training import semantics as t_sem
from sfd2_tpu.training import losses as j_losses
from sfd2_tpu.training import sampler as j_sampler
from sfd2_tpu.training import semantics as j_sem

# The JAX package's training/__init__.py binds the name ap_loss to the function.
j_ap = importlib.import_module("sfd2_tpu.training.ap_loss")

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(3)
TINY_SAMPLER = dict(ngh=3, subq=-4, pos_d=1, neg_d=2, border=3, subd_neg=-4)


def jax_positions(sampler, key, b: int, h: int, w: int):
    """The query and distractor positions the JAX ``NghSampler2DS`` draws
    from `key` (``sfd2_tpu/training/sampler.py:100-105,183-186``)."""
    kq, kd = jax.random.split(key)
    bd = sampler.border
    if sampler.subq < 0:
        nq = sampler.num_queries(h, w)
        x1 = jax.random.randint(kq, (b, nq), bd, w - bd)
        y1 = jax.random.randint(jax.random.fold_in(kq, 1), (b, nq), bd, h - bd)
    else:
        gx, gy = np.meshgrid(np.arange(bd, w - bd, sampler.subq),
                             np.arange(bd, h - bd, sampler.subq))
        x1 = np.broadcast_to(gx.reshape(-1), (b, gx.size))
        y1 = np.broadcast_to(gy.reshape(-1), (b, gy.size))
    x3 = y3 = None
    if sampler.subd_neg:
        nd = sampler.num_queries(h, w)
        x3 = torch.from_numpy(np.array(jax.random.randint(kd, (b, nd), bd, w - bd)))
        y3 = torch.from_numpy(np.array(
            jax.random.randint(jax.random.fold_in(kd, 1), (b, nd), bd, h - bd)))
    return t_sampler.Positions(torch.from_numpy(np.array(x1)), torch.from_numpy(np.array(y1)),
                               x3, y3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(rng, shape):
    d = rng.normal(size=shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def shifted_flow(b, h, w, shift=(3.0, -2.0), invalid_rows=4):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    aflow = np.stack([xs + shift[0], ys + shift[1]], -1)[None].repeat(b, 0)
    aflow[:, :invalid_rows] = np.nan
    return aflow


def test_quantize_and_compute_ap_match_jax():
    rng = np.random.default_rng(0)
    x = rng.random((6, 40)).astype(np.float32)
    lab = (rng.random((6, 40)) < 0.2).astype(np.float32)
    wts = (rng.random((6, 40)) < 0.8).astype(np.float32)
    np.testing.assert_allclose(t_ap.quantize(_t(x), 20).numpy(),
                               np.asarray(j_ap.quantize(jnp.asarray(x), 20)), rtol=0, atol=1e-6)
    for weights in (None, wts):
        for euc in (False, True):
            got = t_ap.compute_ap(_t(x), _t(lab), None if weights is None else _t(weights),
                                  euc=euc)
            ref = j_ap.compute_ap(jnp.asarray(x), jnp.asarray(lab),
                                  None if weights is None else jnp.asarray(weights), euc=euc)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_ap.ap_loss(_t(x), _t(lab)).numpy(),
                               np.asarray(j_ap.ap_loss(jnp.asarray(x), jnp.asarray(lab))),
                               rtol=0, atol=1e-6)


def test_semantics_match_jax():
    labels = np.arange(-3, 160).astype(np.int32)
    conf = t_sem.semantic_to_confidence(_t(labels)).numpy()
    np.testing.assert_allclose(conf, np.asarray(j_sem.semantic_to_confidence(labels)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t_sem.stability_category(_t(labels)).numpy(),
                                  np.asarray(j_sem.stability_category(labels)))
    np.testing.assert_array_equal(t_sem.confidence_to_class(_t(conf)).numpy(),
                                  np.asarray(j_sem.confidence_to_class(jnp.asarray(conf))))


def loss_inputs(rng, b=2, r=64, d=32, stab_channels=3, feats=True):
    """Random SegLossInputs fields (numpy): [2B] pair halves at r², desc
    at r/4, semi at r/8."""
    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    n = 2 * b
    seg = rng.integers(1, 150, size=(n, r, r)).astype(np.int32)
    out = dict(
        semi=softmax(rng.normal(size=(n, r // 8, r // 8, 65))),
        gt_semi=softmax(rng.normal(size=(n, r // 8, r // 8, 65)) * 2),
        score=rng.random((n, r, r)).astype(np.float32) * 0.05,
        gt_score=rng.random((n, r, r)).astype(np.float32) * 0.05,
        desc=_unit(rng, (n, r // 4, r // 4, d)),
        aflow=shifted_flow(b, r, r, (5.0, -3.0), invalid_rows=6),
        weight=np.where(rng.random((n, r, r)) < 0.3, 2.0, 1.0).astype(np.float32),
        seg_mask=rng.random((n, r, r)) < 0.9,
        seg=seg,
        stability=(softmax(rng.normal(size=(n, r, r, 3))) if stab_channels == 3
                   else rng.random((n, r, r, 1)).astype(np.float32)),
    )
    out["seg_confidence"] = np.asarray(j_sem.semantic_to_confidence(seg))
    if feats:
        out["pred_feats"] = (rng.normal(size=(n, r // 2, r // 2, 8)).astype(np.float32),
                             rng.normal(size=(n, r // 4, r // 4, 16)).astype(np.float32))
        out["gt_feats"] = (rng.normal(size=(n, r // 4, r // 4, 8)).astype(np.float32),
                           rng.normal(size=(n, r // 4, r // 4, 16)).astype(np.float32))
    return out


def _as(mod, fields):
    conv = (lambda a: jnp.asarray(a)) if mod is j_losses else _t
    kw = {k: (tuple(conv(f) for f in v) if isinstance(v, tuple) else conv(v))
          for k, v in fields.items()}
    return mod.SegLossInputs(**kw)


LOSS_CASES = [
    dict(),  # the shipped configuration: ce, wapv2, seg_det cls, seg_feat, seg_desc 2mf
    dict(det_loss="l1"), dict(det_loss="bce"), dict(det_loss="sce"),
    dict(desc_loss="tripletv1"), dict(desc_loss="tripletv2"), dict(desc_loss="tripletv3"),
    dict(seg_desc_loss_fn="2m"), dict(seg_desc_loss_fn="wap"),
    dict(seg_cls=False), dict(use_pred_score_desc=False),
]


@pytest.mark.parametrize("overrides", LOSS_CASES, ids=lambda o: "-".join(
    f"{k}={v}" for k, v in o.items()) or "shipped")
def test_seg_loss_terms_match_jax(overrides):
    rng = np.random.default_rng(7)
    fields = loss_inputs(rng, stab_channels=1 if overrides.get("seg_cls") is False else 3)
    cfg = dict(topk_per_half=48, **overrides)
    sampler_kw = TINY_SAMPLER
    ref = j_losses.seg_loss(KEY, _as(j_losses, fields), j_sampler.NghSampler2DS(**sampler_kw),
                            j_losses.SegLossConfig(**cfg))
    ts = t_sampler.NghSampler2DS(**sampler_kw)
    got = t_losses.seg_loss(None, _as(t_losses, fields), ts, t_losses.SegLossConfig(**cfg),
                            positions=jax_positions(ts, KEY, 2, 16, 16))
    assert set(got) == set(ref) and len(got) == 6
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, atol=0, err_msg=k)


def test_cel_is_refused_at_config_time():
    with pytest.raises(ValueError, match="cel"):
        t_losses.SegLossConfig(det_loss="cel")
    with pytest.raises(ValueError, match="unknown det_loss"):
        t_losses.SegLossConfig(det_loss="nope")


def test_topk_ties_go_to_the_lower_index():
    rng = np.random.default_rng(8)
    scores = (rng.integers(0, 4, size=(3, 16, 16)) / 4).astype(np.float32)  # many ties
    got = t_losses._select_topk_pixels(_t(scores), 40)
    ref = j_losses._select_topk_pixels(jnp.asarray(scores), 40)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
