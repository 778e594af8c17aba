"""K5's and K6's plain versions and the large-bank matcher route against the
JAX package.

``nn_argmax`` and ``nn_top2`` (sfd2_torch/ops/matching.py) are the contracts
the CUDA kernels ``nn_argmax_cuda`` and ``nn_top2_cuda`` are held to. They
are held against the Pallas kernels ``nn_argmax_pallas`` and
``nn_top2_pallas`` in interpret mode, as ``tests/test_pallas_match.py``
runs them, across several tiles (so the TPU kernels' cross-tile merges are
exercised). Descriptors are random unit vectors: values agree to float32
rounding (1e-5) and indices exactly. Exact ties come from duplicated
descriptors placed at the same offset inside their tiles, so both packages
compute the tied similarities bit-identically. The kernels' own tests are
in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfd2_torch.ops.matching as tm
from sfd2_tpu.ops import pallas_match as pm

torch.set_num_threads(2)


def unit(rng, *shape):
    d = rng.normal(size=shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _case(rng, b, n1, n2, c, invalid):
    d0, d1 = unit(rng, b, n1, c), unit(rng, b, n2, c)
    m = min(n1, n2) // 2
    d1[:, :m] = d0[:, rng.permutation(n1)[:m]] + 0.3 * unit(rng, b, m, c)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    v0 = rng.random((b, n1)) > invalid
    v1 = rng.random((b, n2)) > invalid
    return d0, d1, v0, v1


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in a]


def _j(*a):
    return [jnp.asarray(x) for x in a]


# [1, 256, 256, 16] in 32-wide tiles (64 tiles), and a batch of two with
# invalid rows and columns in 64-wide tiles (3 × 5 tiles per pair).
CASES = [(1, 256, 256, 16, 32, 0.0), (2, 192, 320, 32, 64, 0.15)]
IDS = ["1x256x256x16", "2x192x320x32-invalid"]


def _check(got, ref, index_slots):
    for k, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        if k in index_slots:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), r)
        else:
            np.testing.assert_allclose(g.numpy(), r, atol=1e-5)


@pytest.mark.parametrize("b,n1,n2,c,block,invalid", CASES, ids=IDS)
def test_nn_argmax_matches_pallas_interpret(rng, b, n1, n2, c, block, invalid):
    d0, d1, v0, v1 = _case(rng, b, n1, n2, c, invalid)
    got = tm.nn_argmax(*_t(d0, d1, v0, v1))
    ref = pm.nn_argmax_pallas(*_j(d0, d1, v0, v1), block, block, interpret=True)
    _check(got, ref, (1, 3))


@pytest.mark.parametrize("b,n1,n2,c,block,invalid", CASES, ids=IDS)
def test_nn_top2_matches_pallas_interpret(rng, b, n1, n2, c, block, invalid):
    d0, d1, v0, v1 = _case(rng, b, n1, n2, c, invalid)
    got = tm.nn_top2(*_t(d0, d1, v0, v1))
    ref = pm.nn_top2_pallas(*_j(d0, d1, v0, v1), block, block, interpret=True)
    _check(got, ref, (1, 4))


def _tie_case(rng):
    """[1, 256, 256, 16], 32-wide tiles: query rows 5 and 69 identical with
    bank column 10 their copy (a row tie on column 10), bank columns 40 and
    104 identical with query row 200 their copy (a column tie on row 200)."""
    d0, d1 = unit(rng, 1, 256, 16), unit(rng, 1, 256, 16)
    d0[0, 69] = d0[0, 5]
    d1[0, 10] = d0[0, 5]
    d1[0, 104] = d1[0, 40]
    d0[0, 200] = d1[0, 40]
    return d0, d1, np.ones((1, 256), bool), np.ones((1, 256), bool)


def test_ties_give_the_lowest_index_both_ways(rng):
    d0, d1, v0, v1 = _tie_case(rng)
    m12, nn12, m21, nn21 = tm.nn_argmax(*_t(d0, d1, v0, v1))
    assert nn21[0, 10] == 5 and nn12[0, 5] == 10 and nn12[0, 69] == 10
    assert nn12[0, 200] == 40 and nn21[0, 40] == 200 and nn21[0, 104] == 200
    _check((m12, nn12, m21, nn21),
           pm.nn_argmax_pallas(*_j(d0, d1, v0, v1), 32, 32, interpret=True), (1, 3))
    top2 = tm.nn_top2(*_t(d0, d1, v0, v1))
    m1, n12, m1b, c1, n21, c1b = top2
    assert m1b[0, 200] == m1[0, 200] and n12[0, 200] == 40  # a max reached twice in a row
    assert c1b[0, 10] == c1[0, 10] and n21[0, 10] == 5      # ... and in a column
    _check(top2, pm.nn_top2_pallas(*_j(d0, d1, v0, v1), 32, 32, interpret=True), (1, 4))


def test_top2_of_a_single_column_is_minus_2e9():
    d0, d1 = _t(unit(np.random.default_rng(0), 1, 4, 8), unit(np.random.default_rng(1), 1, 1, 8))
    m1, nn12, m1b, c1, nn21, c1b = tm.nn_top2(d0, d1)
    assert (m1b == -2e9).all() and (nn12 == 0).all() and (c1b > -2e9).all()


@pytest.mark.parametrize("invalid", [0.0, 0.15])
def test_mutual_nn_match_tiled_matches_pallas(rng, invalid):
    """n = 192 is a multiple of 64, not of 128, so the JAX wrapper takes its
    own tiled branch (64-wide tiles). Rows 0 and 64 identical with column 5
    their copy: the back-pointer grants the tie to row 0 only."""
    d0, d1, v0, v1 = _case(rng, 2, 192, 192, 32, invalid)
    d0[0, 64] = d0[0, 0]
    d1[0, 5] = d0[0, 0]
    v0[0, [0, 64]] = v1[0, 5] = True
    m_t, s_t = tm.mutual_nn_match_tiled(*_t(d0, d1, v0, v1))
    m_j, s_j = pm.mutual_nn_match_pallas(*_j(d0, d1, v0, v1), block_m=64, interpret=True)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    assert m_t[0, 0] == 5 and m_t[0, 64] == -1
    assert (m_t.numpy()[~v0] == -1).all() and (m_t >= 0).sum() > 0


@pytest.mark.parametrize("ratio", [0.8, 0.97])
def test_mutual_nn_ratio_match_tiled_matches_pallas(rng, ratio):
    d0, d1, v0, v1 = _case(rng, 2, 192, 192, 32, 0.15)
    m_t, s_t = tm.mutual_nn_ratio_match_tiled(*_t(d0, d1), ratio, *_t(v0, v1))
    m_j, s_j = pm.mutual_nn_ratio_match_pallas(*_j(d0, d1), ratio, *_j(v0, v1),
                                               interpret=True)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    assert (m_t >= 0).sum() > 0


# The last full-width and the first tiled bank size (multiples of 128) at
# each width; the rule depends only on the bank size and the width.
THRESHOLDS = {128: 68_992, 256: 37_504, 512: 19_584}


@pytest.mark.parametrize("c", sorted(THRESHOLDS))
def test_tiled_route_is_the_jax_rule(c):
    first = THRESHOLDS[c]
    for n in range(first - 20 * 128, first + 20 * 128 + 1, 128):
        assert tm.tiled_route(n, c) == (pm._fullwidth_block_m(n, n, c, 128) is None), n
        assert tm.tiled_route(n, c) == (n >= first), n


@pytest.mark.parametrize("mode", ["nnm", "nnr"])
def test_batch_matcher_takes_the_tiled_route(rng, monkeypatch, mode):
    """With the threshold set low, 128-multiples go to the tiled route (and
    agree with the JAX tiled route), ragged sizes stay on K2/K4."""
    calls = []
    name = "mutual_nn_match_tiled" if mode == "nnm" else "mutual_nn_ratio_match_tiled"
    real = getattr(tm, name)
    monkeypatch.setattr(tm, name, lambda *a: calls.append(a[0].shape) or real(*a))
    monkeypatch.setattr(tm, "_FULLWIDTH_BYTES", 1)
    monkeypatch.setattr(pm, "_FULLWIDTH_VMEM_BYTES", 1)
    d0, d1, v0, v1 = _case(rng, 2, 128, 256, 16, 0.1)
    m_t, _ = tm.batch_matcher(mode, 0.9)(*_t(d0, d1, v0, v1))
    assert calls == [(2, 128, 16)]
    if mode == "nnm":
        m_j, _ = pm.mutual_nn_match_pallas.__wrapped__(*_j(d0, d1, v0, v1), block_m=128,
                                                      interpret=True)
    else:
        m_j, _ = pm.mutual_nn_ratio_match_pallas.__wrapped__(*_j(d0, d1), 0.9, *_j(v0, v1),
                                                            interpret=True)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    tm.batch_matcher(mode, 0.9)(*_t(d0[:, :100], d1, v0[:, :100], v1))
    assert len(calls) == 1  # ragged: K2/K4


def test_batch_matcher_keeps_small_banks_off_the_tiled_route(rng, monkeypatch):
    calls = []
    monkeypatch.setattr(tm, "mutual_nn_match_tiled", lambda *a: calls.append(1))
    d0, d1, v0, v1 = _case(rng, 1, 128, 128, 16, 0.1)
    m, _ = tm.batch_matcher("nnm")(*_t(d0, d1, v0, v1))
    assert not calls and torch.equal(m, tm.mutual_nn_match(*_t(d0, d1, v0, v1))[0])
