"""Differentiable average-precision loss via fixed quantisation.

Port of ``sfd2_tpu/training/ap_loss.py`` (``nets/ap_loss.py:11``,
APLoss): the R2D2 AP loss, whose quantiser the reference builds as a
frozen Conv1d with analytically set weights, written as the triangular
soft histogram it encodes: nq bins spanning [min, max], bin k active
linearly within ±1/a of its centre, the two edge bins half-open.
"""

from __future__ import annotations

import torch


def quantize(x: torch.Tensor, nq: int = 20, vmin: float = 0.0, vmax: float = 1.0):
    """Soft-assign values [..., M] to nq bins → [..., nq, M]
    (``nets/ap_loss.py:32-42``): q = min(−a·x + a·min + (nq−k),
    a·x + (2−nq+k) − a·min), clamped ≥ 0, with bin 0 of the descending side
    and bin nq−1 of the ascending side the constant 1."""
    a = (nq - 1) / (vmax - vmin)
    k = torch.arange(nq, dtype=x.dtype, device=x.device)
    xb = x[..., None, :]
    down = -a * xb + (a * vmin + (nq - k))[:, None]
    up = a * xb + ((2 - nq + k) - a * vmin)[:, None]
    first = torch.zeros(nq, 1, dtype=torch.bool, device=x.device)
    first[0] = True
    down = torch.where(first, 1.0, down)
    up = torch.where(first.flip(0), 1.0, up)
    return torch.clamp(torch.minimum(down, up), min=0.0)


def compute_ap(scores: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor | None = None,
               nq: int = 20, euc: bool = False) -> torch.Tensor:
    """Per-row quantised AP. `scores` / `labels` are [..., M] in [0, 1] /
    {0, 1}; `weights` (optional [..., M]) masks padded columns."""
    if euc:
        scores = 1 - torch.sqrt(torch.clamp(2.001 - 2 * scores, min=0.0))
    q = quantize(scores, nq)  # [..., Q, M]
    lab = labels[..., None, :].to(scores.dtype)
    if weights is not None:
        q = q * weights[..., None, :]
    nbs = q.sum(-1)  # [..., Q]
    rec = (q * lab).sum(-1)
    prec = torch.cumsum(rec, -1) / (1e-16 + torch.cumsum(nbs, -1))
    rec_norm = rec / torch.clamp(rec.sum(-1, keepdim=True), min=1e-16)
    return (prec * rec_norm).sum(-1)


def ap_loss(scores, labels, weights=None, nq: int = 20):
    """1 − AP, per row."""
    return 1.0 - compute_ap(scores, labels, weights, nq)
