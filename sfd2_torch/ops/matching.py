"""Descriptor matching (plain PyTorch; the CUDA kernel is ``cuda_match.py``).

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


def mutual_nn_ratio_match(desc0, desc1, ratio: float = 0.9, valid0=None, valid1=None):
    """Mutual NN + symmetric Lowe ratio on unit-descriptor L2 distances
    d = sqrt(2 − 2·sim) (reference NNR conf, ``it_loc/matcher.py:165-196``)."""
    sim = _masked_similarity(desc0, desc1, valid0, valid1)

    def top2_ratio(s):
        vals, idx = torch.topk(s, 2, dim=-1)
        dist = torch.sqrt(torch.clamp(2.0 - 2.0 * vals, min=0.0))
        return idx[..., 0], dist[..., 0] / (dist[..., 1] + 1e-8), vals[..., 0]

    nn12, ratios12, best12 = top2_ratio(sim)
    nn21, ratios21, _ = top2_ratio(sim.transpose(-1, -2))
    ids = torch.arange(sim.shape[-2], device=sim.device)
    mutual = ids == torch.gather(nn21, -1, nn12)
    ok = mutual & (ratios12 <= ratio) & (torch.gather(ratios21, -1, nn12) <= ratio)
    ok = ok & (best12 > _NEG / 2)
    if valid0 is not None:
        ok = ok & valid0
    matches0 = torch.where(ok, nn12, -1).to(torch.int32)
    scores0 = torch.where(best12 > _NEG / 2, best12, 0.0)
    return matches0, scores0


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

    'nnm' goes to kernel K2 on CUDA tensors for any shape (plain version
    on CPU tensors). 'nnr' raises on CUDA until its kernel (K4) is ported.
    'onn' and 'nnml' are plain PyTorch on every device."""
    if mode not in ("nnm", "nnr", "onn", "nnml"):
        raise ValueError(mode)

    def run(d0, d1, v0, v1, l0=None, l1=None):
        if mode == "nnm":
            from sfd2_torch.ops.cuda_match import mutual_nn_match_cuda

            return mutual_nn_match_cuda(d0, d1, v0, v1)
        if mode == "nnr":
            if d0.is_cuda:
                raise NotImplementedError(
                    "nnr on CUDA needs kernel K4 (mutual_nn_ratio_match), not ported yet")
            return mutual_nn_ratio_match(d0, d1, ratio, v0, v1)
        if mode == "onn":
            return one_way_match(d0, d1, v0, v1)
        return mutual_nn_match_with_labels(d0, d1, l0, l1, v0, v1)

    return run
