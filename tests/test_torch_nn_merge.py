"""The arithmetic of the tensor-core matcher kernels K2, K4, K5 and K6
(``csrc/nn_tc.cuh``), modelled in numpy on the CPU.

1. The epilogue and the cross-tile merge. ``kernel_model`` takes the
   similarity S that the plain version computes, cuts it into the
   kernel's 128 × 128 tiles, reduces each tile as the kernel does (biases
   first; rows by a strictly-greater scan over each lane's columns and a
   butterfly over the quad; columns by a scan of each half column in
   ascending row order, then the two halves), and merges the tiles' pushes in a shuffled order with the
   kernel's atomics: the 64-bit (value, index) key and, for K6, the loser
   rule for the second value. Only the merge and the epilogue are under
   test, so the result must equal ``nn_argmax`` / ``nn_top2`` bit for bit,
   whatever the order, and agree with the Pallas kernels in interpret mode
   under the tolerances of ``test_torch_nn_tiled.py`` (indices exact,
   values 1e-5).
   K2 and K4 run the same tiles and merges (K4 with the second values),
   then their last pass over the merged keys (``epilogue_model``: K2's
   ``match_epilogue``, K4's ``ratio_epilogue``); from the same S the
   result must equal ``mutual_nn_match`` / ``mutual_nn_ratio_match`` bit
   for bit in any tile order, and agree with the Pallas kernels in
   interpret mode (matches identical, scores 1e-5).
2. 3×TF32. Descriptors split into hi = tf32(x), lo = tf32(x − hi)
   (``cvt.rna``: 10 mantissa bits, round to nearest, ties away), products
   lo·hi + hi·lo then hi·hi, accumulated in float32 one wgmma depth (8
   terms) at a time, lie within 1e-5 of the float64 similarity at C = 128
   and 512; a single TF32 pass does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfd2_torch.ops.matching as tm
from sfd2_tpu.ops import pallas_match as pm

torch.set_num_threads(2)

T = 128  # the kernel's tile
F32 = np.float32
NEG, NEG2 = F32(-1e9), F32(-2e9)


def enc(v):
    """The order-preserving int32 encoding of float32 values (as int64)."""
    i = np.asarray(v, F32).view(np.int32).astype(np.int64)
    return np.where(i >= 0, i, i ^ 0x7FFFFFFF)


def dec(e):
    e = np.asarray(e, np.int64)
    return np.where(e >= 0, e, e ^ 0x7FFFFFFF).astype(np.int32).view(F32)


def pack(v, index) -> int:
    hi = (int(enc(v)) ^ 0x80000000) & 0xFFFFFFFF
    return (hi << 32) | (0xFFFFFFFF - int(index))


def key_value(k: int):
    return dec(np.int64(np.uint32((k >> 32) ^ 0x80000000).view(np.int32)))


def key_index(k: int) -> int:
    return 0xFFFFFFFF - (k & 0xFFFFFFFF)


def merge(a, b):
    """(v, vi, v2) ⊕ (ov, oi, ov2): the larger max, the lower index on a
    tie, the multiset second (the kernel's take_top2)."""
    (v, vi, v2), (ov, oi, ov2) = a, b
    second = np.maximum(np.minimum(v, ov), np.maximum(v2, ov2))
    take = (ov > v) | ((ov == v) & (oi < vi))
    return np.where(take, ov, v), np.where(take, oi, vi), second


def tile_reduce(tile, rb, cb):
    """The kernel's in-tile reductions of one [T, T] tile: per row (v, vi,
    v2) over s + column bias, per column over s + row bias, tile-local
    indices. Rows: thread (warp w, lane 4g + t) holds rows 16w + g + {0, 8},
    columns 8i + 2t + {0, 1}, and the quad merges. Columns: two threads
    scan the two halves of a column in shared memory, then merge."""
    s = tile + cb[None, :]
    lanes = []
    for t in range(4):
        v, vi, v2 = np.full(T, -np.inf, F32), np.zeros(T, np.int64), np.full(T, NEG2)
        for j in (8 * i + 2 * t + c for i in range(16) for c in range(2)):  # ascending
            x = s[:, j]
            gt = x > v
            v2 = np.where(gt, np.maximum(v2, v), np.maximum(v2, x))
            vi, v = np.where(gt, j, vi), np.where(gt, x, v)
        lanes.append((v, vi, v2))
    for off in (1, 2):  # the quad
        lanes = [merge(lanes[t], lanes[t ^ off]) for t in range(4)]
    rows = lanes[0]

    s = tile + rb[:, None]
    halves = []
    for half in range(2):  # two threads per column, 64 rows each, ascending
        v, vi, v2 = np.full(T, -np.inf, F32), np.zeros(T, np.int64), np.full(T, NEG2)
        for r in range(half * T // 2, (half + 1) * T // 2):
            x = s[r]
            gt = x > v
            v2 = np.where(gt, np.maximum(v2, v), np.maximum(v2, x))
            vi, v = np.where(gt, r, vi), np.where(gt, x, v)
        halves.append((v, vi, v2))
    (v, vi, v2), (ov, oi, ov2) = halves
    v2 = np.maximum(np.minimum(v, ov), np.maximum(v2, ov2))
    take = ov > v  # the upper half's rows come later: strictly greater
    v, vi = np.where(take, ov, v), np.where(take, oi, vi)
    return rows, (v, vi, v2)


def kernel_model(s, valid0, valid1, top2: bool, rng):
    """K5 (top2=False) or K6 on one pair's S [N1, N2] float32: every tile's
    pushes, in an order shuffled by rng, merged by the kernel's atomics."""
    n1, n2 = s.shape
    rb_all = np.where(valid0, F32(0), NEG).astype(F32)
    cb_all = np.where(valid1, F32(0), NEG).astype(F32)
    pushes = []
    for a in range(-(-n1 // T)):
        for b in range(-(-n2 // T)):
            h, w = min(T, n1 - a * T), min(T, n2 - b * T)
            tile = np.zeros((T, T), F32)  # zero-filled operands past N1, N2
            tile[:h, :w] = s[a * T: a * T + h, b * T: b * T + w]
            rb, cb = np.full(T, -np.inf, F32), np.full(T, -np.inf, F32)
            rb[:h], cb[:w] = rb_all[a * T: a * T + h], cb_all[b * T: b * T + w]
            (rv, ri, r2), (cv, ci, c2) = tile_reduce(tile, rb, cb)
            pushes += [(0, a * T + r, rv[r], b * T + ri[r], r2[r]) for r in range(h)]
            pushes += [(1, b * T + c, cv[c], a * T + ci[c], c2[c]) for c in range(w)]
    order = rng.permutation(len(pushes))
    keys = [[0] * n1, [0] * n2]
    second = [[int(enc(NEG2))] * n1, [int(enc(NEG2))] * n2]
    for p in order:
        side, i, v, index, v2 = pushes[p]
        mine = pack(v, index)
        old = keys[side][i]
        keys[side][i] = max(old, mine)
        if top2:
            sec = v2
            if old != 0:
                sec = max(sec, key_value(min(old, mine)))  # the loser
            second[side][i] = max(second[side][i], int(enc(sec)))
    out = []
    for side in (0, 1):
        out.append(np.array([key_value(k) for k in keys[side]], F32))
        out.append(np.array([key_index(k) for k in keys[side]], np.int32))
        if top2:
            out.append(dec(np.array(second[side])))
    return out


def dist(v):
    """K4's dist, each step rounded to float32 on its own (no contraction),
    as the kernel's round-to-nearest intrinsics compute it."""
    return np.sqrt(np.maximum(F32(2) - F32(2) * np.asarray(v, F32), F32(0)))


def epilogue_model(out, valid0, top2: bool, ratio=F32(0.9)):
    """K2's (top2=False) or K4's last pass over one pair's merged keys, the
    output of ``kernel_model``: a row is alive if it is valid and its key
    value is above −5e8 (its key ignores its own bias); it is matched to its
    key's index nn if the value equals column nn's key value and, for K4,
    both distance ratios pass. → (matches int32, scores float32)."""
    if top2:
        r, nn, r2, c1, _, c2 = out
    else:
        r, nn, c1, _ = out
    alive = valid0 & (r > NEG / 2)
    ok = alive & (r == c1[nn])
    if top2:
        eps = F32(1e-8)
        ok &= (dist(r) / (dist(r2) + eps) <= ratio) & (dist(c1[nn]) / (dist(c2[nn]) + eps) <= ratio)
    return np.where(ok, nn, -1).astype(np.int32), np.where(alive, r, F32(0)).astype(F32)


def unit(rng, *shape):
    d = rng.normal(size=shape).astype(F32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _case(rng, b, n1, n2, c, invalid, ties):
    d0, d1 = unit(rng, b, n1, c), unit(rng, b, n2, c)
    m = min(n1, n2) // 2
    d1[:, :m] = d0[:, rng.permutation(n1)[:m]] + 0.3 * unit(rng, b, m, c)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    v0, v1 = rng.random((b, n1)) > invalid, rng.random((b, n2)) > invalid
    if ties:
        # A column tie (rows 3, 67, 131, 259 identical, column 7 their copy)
        # and a row tie (columns 9, 73 and 137 identical, row 40 their copy),
        # within a tile (other warps, other lanes) and across tiles, and an
        # invalid row and column among them.
        d0[0, [67, 131, 259]] = d0[0, 3]
        d1[0, 7] = d0[0, 3]
        d1[0, [73, 137]] = d1[0, 9]
        d0[0, 40] = d1[0, 9]
        v0[0, [3, 67, 131, 40]] = v1[0, [7, 9, 73, 137]] = True
        v0[0, 259] = v1[0, 100] = False
    return d0, d1, v0, v1


# (b, n1, n2, c, invalid, ties): ragged tiles, invalid rows and columns,
# planted exact ties, and a reduced axis of one entry (N2 = 1).
CASES = [(1, 300, 280, 16, 0.0, True), (2, 256, 384, 32, 0.15, False),
         (1, 290, 150, 8, 0.3, True), (1, 130, 1, 8, 0.0, False)]
IDS = ["1x300x280-ties", "2x256x384-invalid", "1x290x150-invalid-ties", "1x130x1"]


@pytest.mark.parametrize("top2", [False, True], ids=["k5", "k6"])
@pytest.mark.parametrize("b,n1,n2,c,invalid,ties", CASES, ids=IDS)
def test_merge_model_equals_plain_in_any_order(top2, b, n1, n2, c, invalid, ties):
    rng = np.random.default_rng(n1 + n2)
    d0, d1, v0, v1 = _case(rng, b, n1, n2, c, invalid, ties)
    t0, t1 = torch.from_numpy(d0), torch.from_numpy(d1)
    tv0, tv1 = torch.from_numpy(v0), torch.from_numpy(v1)
    plain = (tm.nn_top2 if top2 else tm.nn_argmax)(t0, t1, tv0, tv1)
    s = tm._similarity(t0, t1).numpy()
    if ties:
        assert s[0, 3, 7] == s[0, 67, 7] == s[0, 131, 7] == s[0, 259, 7]
        assert s[0, 40, 9] == s[0, 40, 73] == s[0, 40, 137]
    for order_seed in range(3):
        order_rng = np.random.default_rng(order_seed)
        for k in range(b):
            got = kernel_model(s[k], v0[k], v1[k], top2, order_rng)
            for g, p in zip(got, plain):
                np.testing.assert_array_equal(g, p[k].numpy())
    if ties:
        nn12, nn21 = plain[1][0], plain[4 if top2 else 3][0]
        assert nn12[3] == nn12[67] == nn12[131] == 7 and nn21[7] == 3  # lowest row
        assert nn12[40] == 9 and nn21[9] == nn21[73] == nn21[137] == 40  # lowest column
        if top2:
            assert plain[2][0, 40] == plain[0][0, 40] and plain[5][0, 7] == plain[3][0, 7]
    if n2 == 1 and top2:
        assert (plain[2] == NEG2).all()


@pytest.mark.parametrize("top2", [False, True], ids=["k5", "k6"])
def test_merge_model_agrees_with_pallas_interpret(top2):
    rng = np.random.default_rng(11)
    d0, d1, v0, v1 = _case(rng, 2, 256, 384, 32, 0.15, False)
    s = tm._similarity(torch.from_numpy(d0), torch.from_numpy(d1)).numpy()
    fn = pm.nn_top2_pallas if top2 else pm.nn_argmax_pallas
    ref = fn(*(jnp.asarray(x) for x in (d0, d1, v0, v1)), 64, 64, interpret=True)
    index_slots = (1, 4) if top2 else (1, 3)
    for k in range(2):
        got = kernel_model(s[k], v0[k], v1[k], top2, np.random.default_rng(k))
        for slot, (g, r) in enumerate(zip(got, ref)):
            r = np.asarray(r)[k]
            if slot in index_slots:
                np.testing.assert_array_equal(g, r)
            else:
                np.testing.assert_allclose(g, r, atol=1e-5)


MATCHERS = {"k2": (False, tm.mutual_nn_match), "k4": (True, tm.mutual_nn_ratio_match)}


@pytest.mark.parametrize("kernel", sorted(MATCHERS))
@pytest.mark.parametrize("b,n1,n2,c,invalid,ties", CASES, ids=IDS)
def test_matcher_model_equals_plain_in_any_order(kernel, b, n1, n2, c, invalid, ties):
    """K2/K4: the tiles, merges and last pass from the plain version's S
    give its matches and scores bit for bit, whatever the tile order,
    through invalid rows and columns, exact row ties and a tied column max."""
    top2, plain_fn = MATCHERS[kernel]
    rng = np.random.default_rng(n1 + n2)
    d0, d1, v0, v1 = _case(rng, b, n1, n2, c, invalid, ties)
    t0, t1 = torch.from_numpy(d0), torch.from_numpy(d1)
    tv0, tv1 = torch.from_numpy(v0), torch.from_numpy(v1)
    plain = plain_fn(t0, t1, valid0=tv0, valid1=tv1)
    s = tm._similarity(t0, t1).numpy()
    for order_seed in range(3):
        order_rng = np.random.default_rng(order_seed)
        for k in range(b):
            got = epilogue_model(kernel_model(s[k], v0[k], v1[k], top2, order_rng), v0[k], top2)
            for g, p in zip(got, plain):
                np.testing.assert_array_equal(g, p[k].numpy())
    matches, scores = (p.numpy() for p in plain)
    assert (scores[~v0] == 0).all() and (matches[~v0] == -1).all()  # dead rows
    if ties:
        assert matches[0, 259] == -1 and scores[0, 259] == 0  # invalid row of the column tie
        if not top2:  # max-equality grants a tie to every tying row
            assert matches[0, 3] == matches[0, 67] == matches[0, 131] == 7
            assert matches[0, 40] == 9
        assert matches[0, 3] == matches[0, 67] == matches[0, 131]


@pytest.mark.parametrize("kernel", sorted(MATCHERS))
def test_matcher_model_agrees_with_pallas_interpret(kernel):
    top2, _ = MATCHERS[kernel]
    rng = np.random.default_rng(12)
    d0, d1, v0, v1 = _case(rng, 2, 256, 384, 32, 0.15, False)
    s = tm._similarity(torch.from_numpy(d0), torch.from_numpy(d1)).numpy()
    j = [jnp.asarray(x) for x in (d0, d1, v0, v1)]
    if top2:
        ref = pm.mutual_nn_ratio_match_pallas(j[0], j[1], 0.9, j[2], j[3], block_m=64,
                                              interpret=True)
    else:
        ref = pm.mutual_nn_match_pallas(*j, block_m=64, interpret=True)
    matched = 0
    for k in range(2):
        got = epilogue_model(kernel_model(s[k], v0[k], v1[k], top2, np.random.default_rng(k)),
                             v0[k], top2)
        np.testing.assert_array_equal(got[0], np.asarray(ref[0])[k])
        np.testing.assert_allclose(got[1], np.asarray(ref[1])[k], atol=1e-5)
        matched += int((got[0] >= 0).sum())
    assert matched > 0


def tf32(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest, ties away
    from zero (on the magnitude bits)."""
    bits = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(F32)


def tc_similarity(a, b, passes):
    """Products of `passes` ((A part, B part), ...) summed the wgmma way:
    one depth of 8 terms at a time (exact products, rounded once into the
    float32 accumulator), the passes in order within each depth."""
    acc = np.zeros((a[0].shape[0], b[0].shape[0]), F32)
    for k in range(0, a[0].shape[1], 8):
        for pa, pb in passes:
            part = pa[:, k: k + 8].astype(np.float64) @ pb[:, k: k + 8].astype(np.float64).T
            acc = (acc + part).astype(F32)
    return acc


@pytest.mark.parametrize("c", [128, 512])
def test_3xtf32_is_within_1e5_of_float64(c):
    rng = np.random.default_rng(c)
    x, y = unit(rng, 256, c), unit(rng, 192, c)
    xh, yh = tf32(x), tf32(y)
    xl, yl = tf32(x - xh), tf32(y - yh)
    assert not (xh.view(np.uint32) & 0x1FFF).any() and not (xl.view(np.uint32) & 0x1FFF).any()
    assert np.abs(x - xh).max() <= 2.0 ** -11 * np.abs(x).max()
    exact = x.astype(np.float64) @ y.astype(np.float64).T
    three = tc_similarity((xh, xl), (yh, yl), [(xl, yh), (xh, yl), (xh, yh)])
    one = tc_similarity((xh,), (yh,), [(xh, yh)])
    err3, err1 = np.abs(three - exact).max(), np.abs(one - exact).max()
    assert err3 <= 1e-5, err3
    assert err1 > 1e-5, err1  # one TF32 pass is not enough
    assert err3 < err1 / 20


def test_tf32_rounds_to_nearest_ties_away():
    one = F32(1.0)
    ulp = F32(2.0 ** -10)  # TF32's spacing above 1
    assert tf32(one + ulp * F32(0.5)) == one + ulp  # a tie goes away from zero
    assert tf32(-(one + ulp * F32(0.5))) == -(one + ulp)
    assert tf32(one + ulp * F32(0.49)) == one
    assert tf32(one + ulp * F32(0.51)) == one + ulp
