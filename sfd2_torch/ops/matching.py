"""Descriptor matching (plain PyTorch; the CUDA kernels are ``cuda_match.py``,
``cuda_match_ratio.py``, ``cuda_nn_argmax.py`` and ``cuda_nn_top2.py``).

Port of ``sfd2_tpu/ops/matching.py``: NNM mutual-NN (``it_loc/matcher.py:
122``), NNR mutual-NN + symmetric Lowe ratio (``:165``), one-way NN and
label-aware NNML (``:239``, a masked similarity). Output contract: a dense
``matches0`` index array over query rows (int32, −1 for unmatched) and
``scores0`` = best cosine similarity per row. Every function takes one
pair ``[N, C]`` or a batch of pairs ``[B, N, C]``.

``mutual_nn_match`` is the plain version of kernel K2 and carries the
kernel's contract: validity enters as additive −1e9 biases and mutuality
is decided by max-equality ``rmax[i] == cmax[nn12[i]]``, which grants an
exact tie between rows to every tying row (the JAX package's XLA path
grants it to the lowest row only; the two agree wherever no tie exists).
``mutual_nn_ratio_match`` is the plain version of kernel K4 and carries
its contract the same way.
``nn_argmax`` and ``nn_top2`` are the plain versions of kernels K5 and K6,
the bidirectional reductions of the large-bank route: where the JAX
package's full-width kernels would not fit the TPU's VMEM (``tiled_route``),
``batch_matcher`` sends NNM to ``mutual_nn_match_tiled`` (K5) and NNR to
``mutual_nn_ratio_match_tiled`` (K6), which test mutuality by back-pointer
``nn21[nn12[i]] == i`` and so grant an exact tie between rows to the lowest
row only, as the JAX package does on that route.
``onn`` and ``nnml`` have no TPU kernel in the JAX package, so the plain
functions here are their real implementation.
"""

from __future__ import annotations

import torch

_NEG = -1e9


def _similarity(desc0, desc1):
    return torch.matmul(desc0.float(), desc1.float().transpose(-1, -2))


def _masked_similarity(desc0, desc1, valid0, valid1):
    sim = _similarity(desc0, desc1)
    if valid0 is not None:
        sim = torch.where(valid0[..., :, None], sim, _NEG)
    if valid1 is not None:
        sim = torch.where(valid1[..., None, :], sim, _NEG)
    return sim


def _bias(valid):
    return torch.where(valid, 0.0, _NEG).to(torch.float32)


def mutual_nn_match(desc0, desc1, valid0=None, valid1=None):
    """Mutual (cycle-consistent) nearest-neighbour matching with the K2
    contract: (matches0 [..., N0] int32, scores0 [..., N0] float32)."""
    s = _similarity(desc0, desc1)
    if valid1 is not None:
        s = s + _bias(valid1)[..., None, :]
    if valid0 is not None:
        s = s + _bias(valid0)[..., :, None]
    rmax, nn12 = torch.max(s, dim=-1)  # first occurrence of the max
    cmax = torch.amax(s, dim=-2)
    alive = rmax > _NEG / 2
    ok = (rmax == torch.gather(cmax, -1, nn12)) & alive
    if valid0 is not None:
        ok = ok & valid0
    matches0 = torch.where(ok, nn12, -1).to(torch.int32)
    scores0 = torch.where(alive, rmax, 0.0)
    return matches0, scores0


# The JAX package's name for NNM over a leading pair axis (a vmap there);
# every function here takes a batch of pairs as it is.
mutual_nn_match_batch = mutual_nn_match


def _dist(v):
    """L2 distance of unit descriptors from their similarity."""
    return torch.sqrt(torch.clamp(2.0 - 2.0 * v, min=0.0))


def mutual_nn_ratio_match(desc0, desc1, ratio: float = 0.9, valid0=None, valid1=None):
    """Mutual NN + symmetric Lowe ratio on unit-descriptor L2 distances
    d = sqrt(2 − 2·sim) (reference NNR conf, ``it_loc/matcher.py:165-196``),
    with the K4 contract: the biases of ``mutual_nn_match``; per row the
    max, its first-occurrence argmax nn12 and the second value, per column
    the top-2, each second value taken over the multiset (the max entry
    set to −2e9, so a max reached twice gives second == max); mutuality by
    max-equality ``rmax == cmax[nn12]``. The JAX XLA path tests mutuality
    by back-pointer; the two agree wherever no two rows tie exactly."""
    s = _similarity(desc0, desc1)
    if valid1 is not None:
        s = s + _bias(valid1)[..., None, :]
    if valid0 is not None:
        s = s + _bias(valid0)[..., :, None]
    rmax, nn12 = torch.max(s, dim=-1)  # first occurrence of the max
    rmax2 = s.scatter(-1, nn12[..., None], 2 * _NEG).amax(-1)
    cmax, first = torch.max(s, dim=-2)
    cmax2 = s.scatter(-2, first[..., None, :], 2 * _NEG).amax(-2)
    c1_at = torch.gather(cmax, -1, nn12)
    c2_at = torch.gather(cmax2, -1, nn12)
    alive = rmax > _NEG / 2
    ok = ((rmax == c1_at) & (_dist(rmax) / (_dist(rmax2) + 1e-8) <= ratio)
          & (_dist(c1_at) / (_dist(c2_at) + 1e-8) <= ratio) & alive)
    if valid0 is not None:
        ok = ok & valid0
    matches0 = torch.where(ok, nn12, -1).to(torch.int32)
    scores0 = torch.where(alive, rmax, 0.0)
    return matches0, scores0


def similarity_topk(sim, k: int = 2):
    """Top-k similarities and indices along the last axis."""
    return torch.topk(sim, k, dim=-1)


def nn_argmax(desc0, desc1, valid0=None, valid1=None):
    """Bidirectional nearest neighbours with the K5 contract:
    (max12 [..., N1] f32, nn12 [..., N1] int32, max21 [..., N2] f32,
    nn21 [..., N2] int32).

    Validity enters as additive −1e9 biases: the row reduction runs over
    ``s + col_bias`` and the column reduction over ``s + row_bias`` (each
    reduction sees only the bias of the axis it reduces). On an exact tie the
    argmax is the lowest index, both ways (``pallas_match.py:62-122``: a
    first-occurrence argmax inside a tile and a strictly-greater merge across
    tiles). The TPU kernel starts its accumulators at −2e9, below any biased
    value, so they never show in the result."""
    s = _similarity(desc0, desc1)
    s_row = s if valid1 is None else s + _bias(valid1)[..., None, :]
    s_col = s if valid0 is None else s + _bias(valid0)[..., :, None]
    max12, nn12 = torch.max(s_row, dim=-1)  # first occurrence of the max
    max21, nn21 = torch.max(s_col, dim=-2)
    return max12, nn12.to(torch.int32), max21, nn21.to(torch.int32)


def _top2(s, dim):
    """(max, first-occurrence argmax, multiset second) along `dim`: the
    second is the max with only the argmax entry set to −2e9, so a max
    reached twice gives second == max."""
    m1, a1 = torch.max(s, dim=dim)
    m2 = s.scatter(dim, a1.unsqueeze(dim), 2 * _NEG).amax(dim)
    return m1, a1.to(torch.int32), m2


def nn_top2(desc0, desc1, valid0=None, valid1=None):
    """Bidirectional top-2 with the K6 contract: (max12, nn12, max12_2nd,
    max21, nn21, max21_2nd) with the biases and the lowest-index argmax of
    ``nn_argmax``, and multiset second values (``pallas_match.py:475-530``);
    a reduced axis of length 1 gives a second value of −2e9."""
    s = _similarity(desc0, desc1)
    s_row = s if valid1 is None else s + _bias(valid1)[..., None, :]
    s_col = s if valid0 is None else s + _bias(valid0)[..., :, None]
    return (*_top2(s_row, -1), *_top2(s_col, -2))


def mutual_nn_match_tiled(desc0, desc1, valid0=None, valid1=None):
    """NNM on the large-bank route (``pallas_match.py:385-396``): K5's
    bidirectional argmax, then the back-pointer check ``nn21[nn12[i]] == i``.
    Scores are ``max12``, the row max over ``s + col_bias``. desc [B, N, C]."""
    from sfd2_torch.ops.cuda_nn_argmax import nn_argmax_cuda

    max12, nn12, _, nn21 = nn_argmax_cuda(desc0, desc1, valid0, valid1)
    ids = torch.arange(nn12.shape[-1], dtype=nn12.dtype, device=nn12.device)
    alive = max12 > _NEG / 2
    ok = (ids == torch.gather(nn21, -1, nn12.long())) & alive
    if valid0 is not None:
        ok = ok & valid0
    return torch.where(ok, nn12, -1).to(torch.int32), torch.where(alive, max12, 0.0)


def mutual_nn_ratio_match_tiled(desc0, desc1, ratio: float = 0.9, valid0=None, valid1=None):
    """NNR on the large-bank route (``pallas_match.py:672-692``): K6's
    bidirectional top-2, the back-pointer check, and the symmetric ratio
    test, with ``ratios21`` built over all columns and gathered at nn12."""
    from sfd2_torch.ops.cuda_nn_top2 import nn_top2_cuda

    m1, nn12, m1b, c1, nn21, c1b = nn_top2_cuda(desc0, desc1, valid0, valid1)
    ratios12 = _dist(m1) / (_dist(m1b) + 1e-8)
    ratios21 = _dist(c1) / (_dist(c1b) + 1e-8)
    ids = torch.arange(nn12.shape[-1], dtype=nn12.dtype, device=nn12.device)
    idx = nn12.long()
    alive = m1 > _NEG / 2
    ok = ((ids == torch.gather(nn21, -1, idx)) & (ratios12 <= ratio)
          & (torch.gather(ratios21, -1, idx) <= ratio) & alive)
    if valid0 is not None:
        ok = ok & valid0
    return torch.where(ok, nn12, -1).to(torch.int32), torch.where(alive, m1, 0.0)


# Copied from sfd2_tpu/ops/pallas_match.py:337-354 (``_FULLWIDTH_VMEM_BYTES``,
# ``_fullwidth_block_m``): the JAX package's full-width matcher kernels keep
# the whole bank, a row stripe and reduction temporaries in 40 MiB of VMEM
# and hand larger banks to the tiled kernels. ``batch_matcher`` there passes
# only multiples of 128, so its smallest stripe (8 rows) decides.
_FULLWIDTH_BYTES = 40 << 20


def tiled_route(n2: int, c: int) -> bool:
    """True where the JAX package's matchers take the tiled large-bank
    route for a bank of n2 descriptors of width c (n1, n2 multiples of
    128): 68,992 rows at C=128, 37,504 at 256, 19,584 at 512 and above."""
    bm = 8
    return 4 * (n2 * c + 3 * bm * n2 + 2 * bm * c) > _FULLWIDTH_BYTES


def one_way_match(desc0, desc1, valid0=None, valid1=None):
    """One-directional NN matching (reference ONN conf)."""
    sim = _masked_similarity(desc0, desc1, valid0, valid1)
    best, nn12 = torch.max(sim, dim=-1)
    ok = best > _NEG / 2
    if valid0 is not None:
        ok = ok & valid0
    matches0 = torch.where(ok, nn12, -1).to(torch.int32)
    return matches0, torch.where(ok, best, 0.0)


def mutual_nn_match_with_labels(desc0, desc1, labels0, labels1, valid0=None, valid1=None):
    """Semantic-label-aware mutual NN (reference NNML): pairs are admissible
    iff labels agree or either side is unlabeled (≤ 0); mutual NN with the
    back-pointer check on the masked similarity."""
    sim = _masked_similarity(desc0, desc1, valid0, valid1)
    l0 = labels0[..., :, None]
    l1 = labels1[..., None, :]
    sim = torch.where((l0 == l1) | (l0 <= 0) | (l1 <= 0), sim, _NEG)
    best, nn12 = torch.max(sim, dim=-1)
    nn21 = torch.argmax(sim, dim=-2)
    ids = torch.arange(sim.shape[-2], device=sim.device)
    ok = (ids == torch.gather(nn21, -1, nn12)) & (best > _NEG / 2)
    if valid0 is not None:
        ok = ok & valid0
    matches0 = torch.where(ok, nn12, -1).to(torch.int32)
    return matches0, torch.where(best > _NEG / 2, best, 0.0)


def batch_matcher(mode: str = "nnm", ratio: float = 0.9):
    """The batched matcher for `mode`: (desc0 [B,K,C], desc1 [B,K',C],
    valid0, valid1[, labels0, labels1]) → (matches0, scores0).

    'nnm' and 'nnr' take the large-bank route where the JAX package does
    (K and K' multiples of 128 and ``tiled_route(K', C)``): kernel K5 for
    'nnm', K6 for 'nnr'. Everywhere else, ragged sizes included, 'nnm' goes
    to kernel K2 and 'nnr' to K4. Each runs its plain version on CPU
    tensors. 'onn' and 'nnml' are plain PyTorch on every device."""
    if mode not in ("nnm", "nnr", "onn", "nnml"):
        raise ValueError(mode)

    def run(d0, d1, v0, v1, l0=None, l1=None):
        n1, (n2, c) = d0.shape[-2], d1.shape[-2:]
        if mode in ("nnm", "nnr") and n1 % 128 == 0 and n2 % 128 == 0 and tiled_route(n2, c):
            if mode == "nnm":
                return mutual_nn_match_tiled(d0, d1, v0, v1)
            return mutual_nn_ratio_match_tiled(d0, d1, ratio, v0, v1)
        if mode == "nnm":
            from sfd2_torch.ops.cuda_match import mutual_nn_match_cuda

            return mutual_nn_match_cuda(d0, d1, v0, v1)
        if mode == "nnr":
            from sfd2_torch.ops.cuda_match_ratio import mutual_nn_ratio_match_cuda

            return mutual_nn_ratio_match_cuda(d0, d1, ratio, v0, v1)
        if mode == "onn":
            return one_way_match(d0, d1, v0, v1)
        return mutual_nn_match_with_labels(d0, d1, l0, l1, v0, v1)

    return run
