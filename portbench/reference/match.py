"""Mutual nearest-neighbour matching of one query against DB banks, and the
gap by which a set of matches departs from it.

The similarity is the dot product of the stored descriptors, in float64.
A row i of the query and a column j of a bank match when j is i's best
valid column and i is j's best valid row. ``match_gap`` judges matches
that another program returned for the same inputs: for each of its
matches (i, j), how far S[i, j] lies below the best of row i and of
column j; for each row it left unmatched where the reference matches,
the margin by which the reference's match beats the runners-up of its
row and column. The widest such gap is the reading; exact agreement
reads 0, and the largest possible reading, 2, marks a match on an
invalid row or column.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.precision import round_tf32

INVALID = 2.0  # the reading of a match that uses an invalid row or column


def similarities(q: torch.Tensor, banks: torch.Tensor, qv: torch.Tensor, bv: torch.Tensor,
                 precision: str = "float64") -> torch.Tensor:
    """S [D, K1, K2] of query q [K1, C] against banks [D, K2, C] with invalid
    rows and columns at −inf. `precision`: ``float64`` (the reference) or
    ``tf32`` (operands rounded to TF32, products summed in float32)."""
    if precision == "float64":
        s = torch.einsum("ic,djc->dij", q.double(), banks.double())
    elif precision == "tf32":
        s = torch.einsum("ic,djc->dij", round_tf32(q), round_tf32(banks)).double()
    else:
        raise ValueError(precision)
    mask = qv[None, :, None] & bv[:, None, :]
    return torch.where(mask, s, torch.full_like(s, -torch.inf))


def mutual_matches(s: torch.Tensor) -> torch.Tensor:
    """matches [D, K1] int64 (−1: none) of similarities S [D, K1, K2]."""
    row_best = s.argmax(2)
    col_best = s.argmax(1)
    finite = torch.isfinite(s.amax(2))
    back = torch.gather(col_best, 1, row_best)
    ok = finite & (back == torch.arange(s.shape[1], device=s.device)[None])
    return torch.where(ok, row_best, torch.full_like(row_best, -1))


def match_gap(s: torch.Tensor, matches: torch.Tensor) -> float:
    """The widest gap (module docstring) of `matches` [D, K1] judged
    against the float64 similarities S [D, K1, K2]."""
    d, k1, k2 = s.shape
    top_r = torch.topk(s, min(2, k2), dim=2).values  # [D, K1, 2]
    top_c = torch.topk(s, min(2, k1), dim=1).values  # [D, 2, K2]
    best_r, best_c = top_r[..., 0], top_c[:, 0, :]
    sec_r = top_r[..., 1] if k2 > 1 else torch.full_like(best_r, -torch.inf)
    sec_c = top_c[:, 1, :] if k1 > 1 else torch.full_like(best_c, -torch.inf)
    m = matches.to(s.device).long()
    has = m >= 0
    j = m.clamp(min=0)
    s_ij = torch.gather(s, 2, j[..., None])[..., 0]
    col_best_at = torch.gather(best_c, 1, j)
    gap_m = torch.maximum(best_r - s_ij, col_best_at - s_ij)
    gap_m = torch.where(torch.isfinite(s_ij), gap_m, torch.full_like(gap_m, INVALID))
    ref = mutual_matches(s)
    jr = ref.clamp(min=0)
    margin_r = best_r - sec_r
    margin_c = torch.gather(best_c - sec_c, 1, jr)
    gap_u = torch.minimum(margin_r, margin_c).clamp(max=INVALID)
    gaps = torch.where(has, gap_m, torch.where(ref >= 0, gap_u, torch.zeros_like(gap_u)))
    return float(gaps.max()) if gaps.numel() else 0.0


def bank_valid(nv: np.ndarray, prow: np.ndarray) -> np.ndarray:
    """A DB bank's valid columns as the localizer uses them: stored
    keypoints (a prefix of `nv`) that observe a map point, all invalid
    when three or fewer remain (``it_loc/localize_cv2.py:530``)."""
    k = prow.shape[-1]
    v = (np.arange(k)[None] < np.asarray(nv)[:, None]) & (prow >= 0)
    return v & (v.sum(1, keepdims=True) > 3)
