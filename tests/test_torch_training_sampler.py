"""The port's samplers and extra losses against the JAX package's.

Every sampler of ``make_sampler``, fed the positions ``jax.random`` draws
for the same key (``test_torch_training_losses.jax_positions``), gives the
same integer and boolean outputs exactly and scores within 1e-6 (inputs
from numpy seeds); ``grid_sample_bilinear`` within 1e-6; CosimLoss,
PeakyLoss and TripletLoss v3 within 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.ops.grid_sample import grid_sample_bilinear as t_grid_sample
from sfd2_torch.training import extra_losses as t_extra
from sfd2_torch.training import sampler as t_sampler
from sfd2_tpu.ops.grid_sample import grid_sample_bilinear as j_grid_sample
from sfd2_tpu.training import extra_losses as j_extra
from sfd2_tpu.training import sampler as j_sampler
from test_torch_training_losses import KEY, TINY_SAMPLER, _t, _unit, jax_positions, shifted_flow

torch.set_num_threads(2)


def _ds_inputs(rng, b=2, h=24, w=24, d=16, scale=4, seg=True):
    hf, wf = h * scale, w * scale
    out = dict(feat1=_unit(rng, (b, h, w, d)), feat2=_unit(rng, (b, h, w, d)),
               conf1=rng.random((b, hf, wf)).astype(np.float32),
               conf2=rng.random((b, hf, wf)).astype(np.float32),
               aflow=shifted_flow(b, hf, wf, (6.0, -5.0), invalid_rows=8))
    if seg:
        out["seg1"] = rng.integers(1, 4, size=(b, hf, wf)).astype(np.int32)
        out["seg2"] = rng.integers(1, 4, size=(b, hf, wf)).astype(np.int32)
    return out


SAMPLERS = [
    ("ngh2ds", {}, 32, 4, False),  # the shipped configuration
    ("ngh2ds", TINY_SAMPLER, 24, 4, False),
    ("ngh2ds", TINY_SAMPLER, 24, 4, True),  # forward2's seg-aware distractors
    ("ngh2ds", dict(TINY_SAMPLER, subq=4, subd_neg=0, maxpool_pos=False), 24, 4, False),
    ("ngh2", dict(TINY_SAMPLER), 24, 1, True),
    ("sub", dict(border=2, subq=4, subd=2), 24, 1, False),
    ("full", {}, 12, 1, False),
    ("ngh", dict(ngh=3, subq=2), 24, 1, False),
    ("farnear", dict(subq=4, ngh=3, subd_far=4), 24, 1, False),
    ("farnear", dict(subq=4, ngh=3, subd_far=4, maxpool_ngh=True), 24, 1, False),
]


@pytest.mark.parametrize("name,kwargs,h,scale,use_seg", SAMPLERS)
def test_samplers_match_jax(name, kwargs, h, scale, use_seg):
    rng = np.random.default_rng(5)
    inp = _ds_inputs(rng, h=h, w=h, scale=scale, seg=use_seg)
    if scale == 1:  # single-resolution samplers: the flow on the map's grid
        inp["aflow"] = shifted_flow(2, h, h, (2.0, -1.0), invalid_rows=2)
    js, ts = j_sampler.make_sampler(name, **kwargs), t_sampler.make_sampler(name, **kwargs)
    args = [inp[k] for k in ("feat1", "feat2", "conf1", "conf2", "aflow")]
    segs = (inp["seg1"], inp["seg2"]) if use_seg else (None, None)
    ref = js(KEY, *[jnp.asarray(a) for a in args],
             *[None if s is None else jnp.asarray(s) for s in segs])
    pos = jax_positions(js, KEY, 2, h, h) if name.startswith("ngh2") else None
    got = ts(None, *[_t(a) for a in args], *[None if s is None else _t(s) for s in segs],
             positions=pos)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.gt.numpy(), np.asarray(ref.gt))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.col_weights.numpy(), np.asarray(ref.col_weights))
    np.testing.assert_allclose(got.qconf.numpy(), np.asarray(ref.qconf), rtol=0, atol=1e-6)
    assert got.mask.any()


def test_sampler_draws_from_its_generator():
    s = t_sampler.NghSampler2DS(**TINY_SAMPLER)
    a = s.sample_positions(torch.Generator().manual_seed(4), 2, 24, 24)
    b = s.sample_positions(torch.Generator().manual_seed(4), 2, 24, 24)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert int(a.x1.min()) >= 3 and int(a.x1.max()) < 21
    assert a.x1.shape == (2, s.num_queries(24, 24))


def test_grid_sample_and_extra_losses_match_jax():
    rng = np.random.default_rng(6)
    fmap = rng.normal(size=(10, 12, 3)).astype(np.float32)
    grid = (rng.random((7, 5, 2)) * 2.4 - 1.2).astype(np.float32)
    for ac in (False, True):
        np.testing.assert_allclose(
            t_grid_sample(_t(fmap), _t(grid), align_corners=ac).numpy(),
            np.asarray(j_grid_sample(jnp.asarray(fmap), jnp.asarray(grid), align_corners=ac)),
            rtol=0, atol=1e-6)
    s1, s2 = rng.random((2, 32, 32)).astype(np.float32), rng.random((2, 32, 32)).astype(np.float32)
    aflow = shifted_flow(2, 32, 32, (1.5, -0.5), invalid_rows=3)
    for got, ref in ((t_extra.cosim_loss(_t(s1), _t(s2), _t(aflow)),
                      j_extra.cosim_loss(jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(aflow))),
                     (t_extra.peaky_loss(_t(s1)), j_extra.peaky_loss(jnp.asarray(s1)))):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_triplet_v3_matches_jax():
    rng = np.random.default_rng(9)
    b, h = 2, 20
    d1, d2 = _unit(rng, (b, h, h, 16)), _unit(rng, (b, h, h, 16))
    c1 = rng.random((b, h, h)).astype(np.float32) + 0.3
    c2 = rng.random((b, h, h)).astype(np.float32) + 0.3
    aflow = shifted_flow(b, h, h, (1.0, 2.0), invalid_rows=2)
    s1 = rng.integers(0, 3, size=(b, h, h)).astype(np.int32)
    s2 = rng.integers(0, 3, size=(b, h, h)).astype(np.int32)
    m1, m2 = rng.random((b, h, h)) < 0.9, rng.random((b, h, h)) < 0.9
    args = (d1, d2, c1, c2, aflow, s1, s2, m1, m2)
    got = t_extra.triplet_loss_v3(*[_t(a) for a in args], border=3)
    ref = j_extra.triplet_loss_v3(*[jnp.asarray(a) for a in args], border=3)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
