"""K2's plain version and the other matchers against the JAX package.

``mutual_nn_match`` (sfd2_torch/ops/matching.py) is the contract the CUDA
kernel ``mutual_nn_match_cuda`` is held to: the max-equality mutuality of
the Pallas kernel ``mutual_nn_match_pallas``. It is held against that
kernel in interpret mode and against the JAX XLA path, which agree with
it wherever no two rows tie exactly. Descriptors are random unit vectors,
so similarities agree to float32 rounding (1e-5) and matches exactly. The
kernel's own tests are in ``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.ops.matching import (
    batch_matcher,
    mutual_nn_match,
    mutual_nn_match_with_labels,
    mutual_nn_ratio_match,
    one_way_match,
)
from sfd2_tpu.ops import matching as jm
from sfd2_tpu.ops.pallas_match import mutual_nn_match_pallas

# The suite runs in several worker processes on a few cores: keep each
# worker's intra-op thread pool small so workers do not oversubscribe them.
torch.set_num_threads(2)


def unit(rng, *shape):
    d = rng.normal(size=shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _pair(rng, b, n1, n2, c=32, invalid=0.1):
    """Banks where half of desc1's rows are noisy copies of desc0 rows, so
    real mutual matches exist, with ~10 % invalid rows and columns."""
    d0 = unit(rng, b, n1, c)
    d1 = unit(rng, b, n2, c)
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


@pytest.mark.parametrize("b,n1,n2", [(1, 128, 128), (2, 128, 256), (3, 100, 75)])
def test_mutual_nn_match_matches_jax_xla(rng, b, n1, n2):
    d0, d1, v0, v1 = _pair(rng, b, n1, n2)
    m_t, s_t = mutual_nn_match(*_t(d0, d1, v0, v1))
    m_j, s_j = jax.vmap(jm.mutual_nn_match)(*_j(d0, d1, v0, v1))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    assert m_t.dtype == torch.int32 and (m_t >= 0).sum() > 0
    assert (m_t.numpy()[~v0] == -1).all()
    hit = m_t.numpy() >= 0
    assert v1[np.nonzero(hit)[0], m_t.numpy()[hit]].all()  # never an invalid column


@pytest.mark.parametrize("b,n1,n2", [(1, 128, 128), (2, 128, 256)])
def test_mutual_nn_match_matches_pallas_interpret(rng, b, n1, n2):
    d0, d1, v0, v1 = _pair(rng, b, n1, n2)
    m_t, s_t = mutual_nn_match(*_t(d0, d1, v0, v1))
    m_p, s_p = mutual_nn_match_pallas(*_j(d0, d1, v0, v1), block_m=64, interpret=True)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_p))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_p), atol=1e-5)


def test_mutual_tie_semantics_match_pallas(rng):
    """The case of tests/test_pallas_match.py: rows 0 and 64 identical with
    column 5 their common best. Max-equality grants both rows, as the
    Pallas kernel does; the XLA back-pointer check keeps the first only."""
    b, n, c = 1, 128, 16
    d0 = unit(rng, b, n, c)
    d0[:, 64] = d0[:, 0]
    d1 = unit(rng, b, n, c)
    d1[:, 5] = d0[:, 0]
    m_t, _ = mutual_nn_match(*_t(d0, d1))
    m_p, _ = mutual_nn_match_pallas(*_j(d0, d1), None, None, block_m=64, interpret=True)
    m_t = m_t.numpy()
    assert m_t[0, 0] == 5 and m_t[0, 64] == 5
    np.testing.assert_array_equal(m_t, np.asarray(m_p))
    m_x, _ = jax.vmap(jm.mutual_nn_match)(*_j(d0, d1))
    untied = np.ones(n, bool)
    untied[[0, 64]] = False
    np.testing.assert_array_equal(m_t[0, untied], np.asarray(m_x)[0, untied])


def test_mutual_nn_match_single_pair_and_no_masks(rng):
    d0, d1 = unit(rng, 40, 16), unit(rng, 50, 16)
    m_t, s_t = mutual_nn_match(*_t(d0, d1))
    m_j, s_j = jm.mutual_nn_match(*_j(d0, d1))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)


@pytest.mark.parametrize("ratio", [0.8, 0.97])
def test_ratio_match_matches_jax(rng, ratio):
    d0, d1, v0, v1 = _pair(rng, 2, 96, 80)
    m_t, s_t = mutual_nn_ratio_match(*_t(d0, d1), ratio, *_t(v0, v1))
    m_j, s_j = jax.vmap(lambda a, b, x, y: jm.mutual_nn_ratio_match(a, b, ratio, x, y))(
        *_j(d0, d1, v0, v1))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)


def test_one_way_match_matches_jax(rng):
    d0, d1, v0, v1 = _pair(rng, 2, 64, 90)
    m_t, s_t = one_way_match(*_t(d0, d1, v0, v1))
    m_j, s_j = jax.vmap(jm.one_way_match)(*_j(d0, d1, v0, v1))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)


def test_label_aware_match_matches_jax(rng):
    d0, d1, v0, v1 = _pair(rng, 2, 64, 72)
    l0 = rng.integers(0, 4, (2, 64)).astype(np.int32)
    l1 = rng.integers(0, 4, (2, 72)).astype(np.int32)
    m_t, s_t = mutual_nn_match_with_labels(*_t(d0, d1, l0, l1, v0, v1))
    m_j, s_j = jax.vmap(jm.mutual_nn_match_with_labels)(*_j(d0, d1, l0, l1, v0, v1))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    m = m_t.numpy()
    for bi, i in zip(*np.nonzero(m >= 0)):  # a labeled row never meets another label
        a, b = l0[bi, i], l1[bi, m[bi, i]]
        assert a == b or a <= 0 or b <= 0


@pytest.mark.parametrize("mode", ["nnm", "nnr", "onn", "nnml"])
def test_batch_matcher_matches_jax_on_cpu(rng, mode):
    d0, d1, v0, v1 = _pair(rng, 2, 64, 64)
    extra = [rng.integers(0, 3, (2, 64)).astype(np.int32) for _ in range(2)] \
        if mode == "nnml" else []
    m_t, _ = batch_matcher(mode, 0.9)(*_t(d0, d1, v0, v1, *extra))
    m_j, _ = jm.batch_matcher(mode, 0.9, backend="xla")(*_j(d0, d1, v0, v1, *extra))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def test_batch_matcher_rejects_unknown_mode():
    with pytest.raises(ValueError):
        batch_matcher("sgm")
