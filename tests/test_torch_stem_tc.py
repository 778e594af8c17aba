"""A numpy model of K1 on the tensor cores (``sfd2_torch/csrc/stem.cu``).

The CUDA kernel runs only on the card; this model repeats its arithmetic
and its index maps on the CPU, block by block in the kernel's tile order
(8 × 16 out1c pixels per block, two warpgroups of an 8 × 8 half each):

* stage A: conv1a as a GEMM over the 561 pixels of the 17 × 33 out1a
  region (K = 27 patch terms padded to 32, B decoded from
  ``stem_tc_w1_image``), relu(· + b1) written into the four stride-2
  parity planes of the kernel's shared memory with its 16-byte-piece
  swizzle (zeros outside the image);
* stage B: conv1b as an implicit GEMM over the 9 taps, each tap a shifted
  window of one parity plane; A fragments read through the kernel's
  register map (row 16·warp + g (+ 8), k t and t + 4, channels permuted
  within a tap as ``stem_tc_k_channel`` says), B decoded from
  ``stem_tc_weight_image`` through the 128-byte swizzle;
* 3×TF32: hi = tf32(x), lo = tf32(x − hi) with round-to-nearest-away
  (``cvt.rna``), per k-step of 8 the products lo·hi, hi·lo, then hi·hi,
  each summed exactly and rounded once into the float32 accumulator (as
  ``tests/test_torch_nn_merge.py`` models wgmma).

It is held to the plain ``fused_stem_apply`` and to the JAX package's
Pallas stem in interpret mode within 1e-4 relative (float32 sums in
another order over 27 + 576 terms), and it fails that bar without the lo
terms (one TF32 pass keeps about three decimal digits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.ops.cuda_stem import (StemWeights, stem_tc_k_channel, stem_tc_w1_image,
                                      stem_tc_weight_image, tf32_round)
from sfd2_torch.ops.stem import fused_stem_apply, repack_stem_params
from sfd2_tpu.ops import stem as jstem
from sfd2_tpu.ops.pallas_stem import StemWeights as PallasStemWeights
from sfd2_tpu.ops.pallas_stem import stem_pallas_apply

torch.set_num_threads(2)

F32 = np.float32
TH, TW = 8, 16                      # out1c tile
A_H, A_W = 2 * TH + 1, 2 * TW + 1   # out1a region
PR, PC = ((A_H + 1) // 2, A_H // 2), ((A_W + 1) // 2, A_W // 2)  # plane rows / columns by parity
OFF = {(0, 0): 0}
OFF[(0, 1)] = PR[0] * PC[0]
OFF[(1, 0)] = OFF[(0, 1)] + PR[0] * PC[1]
OFF[(1, 1)] = OFF[(1, 0)] + PR[1] * PC[0]
PIXELS = OFF[(1, 1)] + PR[1] * PC[1]


def tf32(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest, ties away
    from zero (on the magnitude bits)."""
    bits = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(F32)


def plane_pixel(r, c):
    """Region pixel (r, c) → its pixel index in the parity planes."""
    r, c = np.asarray(r), np.asarray(c)
    off = np.select([(r % 2 == 0) & (c % 2 == 0), r % 2 == 0, c % 2 == 0],
                    [OFF[(0, 0)], OFF[(0, 1)], OFF[(1, 0)]], OFF[(1, 1)])
    return off + (r // 2) * np.where(c % 2, PC[1], PC[0]) + c // 2


def piece(p, q):
    """Float offset of the 16-byte piece q (channels 4q .. 4q + 3) of plane
    pixel p: the piece sits at q ^ 4·(p mod 2)."""
    return p * 64 + ((q ^ ((p & 1) << 2)) << 2)


def tc_accumulate(acc, a, bt, lo_terms=True):
    """acc [M, 64] float32 += A [M, K] · B [K, 64] the kernel's way: per
    k-step of 8, lo·hi, hi·lo, then hi·hi (A split here, Bᵀ = bt (hi, lo)
    [64, K] already split), each summed exactly and rounded once into the
    float32 accumulator."""
    a_hi = tf32(a)
    a_lo = tf32(a - a_hi)
    b_hi, b_lo = bt
    passes = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if lo_terms else [(a_hi, b_hi)]
    for k in range(0, a.shape[1], 8):
        for pa, pb in passes:
            part = pa[:, k:k + 8].astype(np.float64) @ pb[:, k:k + 8].astype(np.float64).T
            acc = (acc + part).astype(F32)
    return acc


def stage_a(x, w1_bt, b1, b, oy0, ox0, lo_terms=True):
    """The block's shared planes [PIXELS·64]: relu(conv1a + b1) of its
    out1a region, zeros outside the image. conv1a is the kernel's GEMM:
    row m = r·33 + c of the region (9 tiles of 64, rows past 561 read the
    last pixel), k = (dy·3 + dx)·3 + ci < 27 reads the patch at (r + dy,
    c + dx, ci), the padding terms the pixel itself."""
    _, h, w, _ = x.shape
    ay0, ax0 = 2 * oy0 - 1, 2 * ox0 - 1
    xp = np.zeros((A_H + 2, A_W + 2, 3), F32)
    ys, xs = np.arange(ay0 - 1, ay0 + A_H + 1), np.arange(ax0 - 1, ax0 + A_W + 1)
    iy, ix = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
    xp[np.ix_(iy, ix)] = x[b][np.ix_(ys[iy], xs[ix])]
    m = np.minimum(np.arange(-(-PIXELS // 64) * 64), PIXELS - 1)
    k = np.arange(32)
    dy, dx, ci = np.where(k < 27, k // 9, 0), np.where(k < 27, k // 3 % 3, 0), np.where(k < 27, k % 3, 0)
    a_mat = xp[(m // A_W)[:, None] + dy, (m % A_W)[:, None] + dx, ci]
    acc = tc_accumulate(np.zeros((len(m), 64), F32), a_mat, w1_bt, lo_terms)[:PIXELS]
    a = np.maximum(acc + b1, 0).astype(F32).reshape(A_H, A_W, 64)
    gy, gx = ay0 + np.arange(A_H), ax0 + np.arange(A_W)
    a[~((gy >= 0) & (gy < h))] = 0
    a[:, ~((gx >= 0) & (gx < w))] = 0
    smem = np.full(PIXELS * 64, np.nan, F32)  # every read must land on a written float
    r, c, co = np.meshgrid(np.arange(A_H), np.arange(A_W), np.arange(64), indexing="ij")
    smem[piece(plane_pixel(r, c), co >> 2) + (co & 3)] = a
    return smem


def fragment_a(smem, tap, wg):
    """A [64 rows, 64 k] of one warpgroup and tap, read through the kernel's
    map: row 16·warp + 8h + g is out1c pixel (2·warp + h, 8wg + g); the
    thread (g, t) loads the float4 of channels 16u + 4t .. of that pixel of
    plane (dy mod 2, dx mod 2) at (row + dy / 2, column + dx / 2), and its
    element 2e (2e + 1) is k t (t + 4) of k-step 2u + e."""
    dy, dx = divmod(tap, 3)
    m = np.arange(64)
    warp, h, g = m // 16, m % 16 // 8, m % 8
    p = plane_pixel(2 * (2 * warp + h) + dy, 2 * (8 * wg + g) + dx)
    kpos = np.arange(64)
    s, j = kpos // 8, kpos % 8
    q = 4 * (s // 2) + j % 4
    return smem[piece(p[:, None], q[None, :]) + 2 * (s % 2) + j // 4]


def fragment_bt(img):
    """Bᵀ [64 co, 32·chunks k] from one part of a weight image [chunks, 64,
    32], read through the 128-byte swizzle as wgmma reads it (k-step s at
    byte 32(s mod 4) of k chunk s // 4)."""
    co = np.arange(64)[:, None]
    kpos = np.arange(32 * img.shape[0])[None, :]
    f = kpos % 32
    phys = ((f // 4) ^ (co % 8)) * 4 + f % 4
    return img[kpos // 32, co, phys]


def stem_tc_model(x, sw: StemWeights, lo_terms: bool = True):
    """The kernel's out1c [B, H/2, W/2, 64] float32 for x [B, H, W, 3]."""
    b1, b2 = sw.b1.numpy(), sw.b2.numpy()
    w1_bt = [fragment_bt(part) for part in sw.w1_tc.numpy()]
    w2_bt = [[fragment_bt(part) for part in tap] for tap in sw.w2_tc.numpy()]
    bs, h, w, _ = x.shape
    h2, w2 = h // 2, w // 2
    out = np.zeros((bs, h2, w2, 64), F32)
    for b in range(bs):
        for by in range(-(-h2 // TH)):
            for bx in range(-(-w2 // TW)):
                oy0, ox0 = by * TH, bx * TW
                smem = stage_a(x, w1_bt, b1, b, oy0, ox0, lo_terms)
                for wg in range(2):
                    acc = np.zeros((64, 64), F32)
                    for tap in range(9):
                        a = fragment_a(smem, tap, wg)
                        assert not np.isnan(a).any()
                        acc = tc_accumulate(acc, a, w2_bt[tap], lo_terms)
                    y = np.maximum(acc + b2, 0).astype(F32)
                    m = np.arange(64)
                    oy = oy0 + 2 * (m // 16) + m % 16 // 8
                    ox = ox0 + 8 * wg + m % 8
                    ok = (oy < h2) & (ox < w2)
                    out[b, oy[ok], ox[ok]] = y[ok]
    return out


def _stem_arrays(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(F32)  # noqa: E731
    return dict(w1=f(64, 3, 3, 3, scale=0.2), b1=f(64, scale=0.1), m1=f(64, scale=0.2),
                v1=np.exp(f(64, scale=0.3)), w2=f(64, 64, 3, 3, scale=0.1), b2=f(64, scale=0.1),
                m2=f(64, scale=0.1), v2=np.exp(f(64, scale=0.2)))


@pytest.fixture(scope="module")
def weights():
    a = _stem_arrays(0)
    t = lambda k: torch.from_numpy(a[k].copy())  # noqa: E731
    state = {"conv1a.0.weight": t("w1"), "conv1a.0.bias": t("b1"),
             "conv1a.1.running_mean": t("m1"), "conv1a.1.running_var": t("v1"),
             "conv1b.0.weight": t("w2"), "conv1b.0.bias": t("b2"),
             "bn1b.0.running_mean": t("m2"), "bn1b.0.running_var": t("v2")}
    hwio = lambda w: np.transpose(w, (2, 3, 1, 0))  # noqa: E731
    jpacked = jstem.repack_stem_params(
        {"conv1a": {"conv": {"kernel": hwio(a["w1"]), "bias": a["b1"]}},
         "conv1b": {"conv": {"kernel": hwio(a["w2"]), "bias": a["b2"]}}},
        {"conv1a": {"bn": {"mean": a["m1"], "var": a["v1"]}},
         "bn1b": {"bn": {"mean": a["m2"], "var": a["v2"]}}})
    packed = repack_stem_params(state)
    return packed, StemWeights(packed, "cpu"), jpacked


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# Two tiles each way with ragged last tiles (out1c 11 × 20, 8 × 17), a batch.
SHAPES = [(1, 22, 40, 3), (2, 16, 34, 3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_model_equals_plain_stem(weights, shape):
    packed, sw, _ = weights
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(F32)
    ref = fused_stem_apply(torch.from_numpy(x), packed).numpy()
    got = stem_tc_model(x, sw)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-4, _rel(got, ref)
    # Mutation check: without the lo terms (one TF32 pass) the bar fails.
    assert _rel(stem_tc_model(x, sw, lo_terms=False), ref) > 1e-4


def test_model_equals_pallas_stem_interpret(weights):
    _, sw, jpacked = weights
    x = np.random.default_rng(5).normal(size=SHAPES[0]).astype(F32)
    ref = np.asarray(stem_pallas_apply(jnp.asarray(x), PallasStemWeights(jpacked),
                                       dtype=jnp.float32, interpret=True))
    got = stem_tc_model(x, sw)
    assert _rel(got, ref) <= 1e-4, _rel(got, ref)


def test_weight_images_hold_hi_and_lo_in_kernel_order(weights):
    """Decoded through the swizzle, the images are tf32(w) and tf32(w − hi):
    conv1b's of every tap in the k order of ``stem_tc_k_channel``, a
    permutation; conv1a's in (dy, dx, ci) order, zero past k = 27."""
    _, sw, _ = weights
    w2 = sw.w2.numpy().reshape(9, 64, 64)  # [tap, ci, co]
    ch = stem_tc_k_channel().numpy()
    assert sorted(ch) == list(range(64))
    img = stem_tc_weight_image(sw.w2.reshape(3, 3, 64, 64)).numpy()
    assert np.array_equal(img, sw.w2_tc.numpy())
    for tap in range(9):
        hi, lo = (fragment_bt(part) for part in img[tap])
        np.testing.assert_array_equal(hi, tf32(w2[tap][ch].T))
        np.testing.assert_array_equal(lo, tf32(w2[tap][ch].T - hi))
        assert np.abs(hi + lo - w2[tap][ch].T).max() <= 2.0 ** -21 * np.abs(w2).max()
    img1 = stem_tc_w1_image(sw.w1.reshape(3, 3, 3, 64)).numpy()
    assert np.array_equal(img1, sw.w1_tc.numpy())
    w1 = np.concatenate([sw.w1.numpy(), np.zeros((5, 64), F32)]).T  # Bᵀ [co, 32]
    hi, lo = (fragment_bt(part) for part in img1)
    np.testing.assert_array_equal(hi, tf32(w1))
    np.testing.assert_array_equal(lo, tf32(w1 - hi))


def test_tf32_round_is_cvt_rna():
    x = np.random.default_rng(1).normal(size=4096).astype(F32)
    one, ulp = F32(1.0), F32(2.0 ** -10)
    x[:2] = [one + ulp * F32(0.5), -(one + ulp * F32(0.5))]  # ties go away from zero
    np.testing.assert_array_equal(tf32_round(torch.from_numpy(x)).numpy(), tf32(x))
    assert tf32(x[:2]).tolist() == [one + ulp, -(one + ulp)]


def test_shared_memory_maps_are_bijective_and_free_of_bank_conflicts():
    """The planes hold each region pixel once, each pixel's 16 pieces once;
    stage B's fragment loads (a quarter-warp's float4s: pixels g, g + 1 of
    one row, pieces t = 0..3) hit 32 distinct banks."""
    r, c = np.meshgrid(np.arange(A_H), np.arange(A_W), indexing="ij")
    p = plane_pixel(r, c).ravel()
    assert sorted(p) == list(range(PIXELS))
    q = np.arange(16)
    for pix in range(PIXELS):
        assert sorted(piece(pix, q) - pix * 64) == list(range(0, 64, 4))
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        for g0 in range(0, 8, 2):
            for u in range(4):
                banks = set()
                for g in (g0, g0 + 1):
                    pix = plane_pixel(dy, 2 * g + dx)
                    for t in range(4):
                        start = piece(pix, 4 * u + t) % 32
                        banks.update(range(start, start + 4))
                assert len(banks) == 32, (tap, g0, u)
