"""Parity of two-view F-RANSAC's CUDA kernels (``ops/cuda_twoview.py``) with
the plain version (``sfm/twoview.py``): the gaps and the rules that
``tests/test_torch_twoview_kernel.py`` and ``chip_smoke.py`` both hold the
kernels to.

Hypotheses, in pixel coordinates (the configuration's): the float32 fit is
decided by rounding in its rank-2 projection, where FᵀF spans ~10 decades,
so two float32 versions that sum in other orders cannot agree to 1e-4 on
every hypothesis; on an H100 the plain version itself sits a median 0.6–1.2 %
(90th percentile 20–60 %) from its float64 run. ``score_failures`` holds
every hypothesis' MSAC, on the same samples, to a quarter of that gap from
the plain version's and as near float64 as the plain version (medians and
90th percentiles), with at least a quarter of them within 1e-4.

Local optimisation, on its own (``lo_case``, ``lo_gaps``, ``lo_failures``):
in pixel coordinates a float32 re-fit seldom beats the winner, so a
``twoview_refine`` that skipped or mis-weighted its steps would pass the
checks above. It is run from a given F in normalised coordinates (the
matches about the principal point over the focal length, the threshold
with them), where float32 is not decided by rounding: the 4 steps improve
an eight-point start on every pair (~2× in MSAC) and the plain version sits
a median ~1e-6 from its float64 run. The kernel's MSAC after the steps must
sit as near float64 as the plain version's, within a factor of 3 (medians
and 90th percentiles over 128 pairs): on the CPU the plain version summing
in another order sits within 0.6–1.8 of it, while skipping the steps puts
it ~10⁶ times as far, hard weights 150–550 times, three steps for four
5–230 times (medians; 600–5,500 times at the 90th percentile).
"""

from __future__ import annotations

import numpy as np
import torch

from sfd2_torch.ops import cuda_twoview
from sfd2_torch.sfm import twoview
from sfd2_torch.utils.synth import two_view_pairs

THR = 4.0  # px: the configuration's threshold
FOCAL, CENTRE = 800.0, (512.0, 384.0)  # two_view_pairs' camera


def _msac_of(xy1, xy2, valid, idx, thr2):
    """Every hypothesis' MSAC by the plain helpers (inf where the fit is not
    finite), as float64."""
    rows = torch.arange(xy1.shape[0], device=xy1.device)[:, None, None]
    fs = twoview._fit_fundamental_lanes(xy1[rows, idx], xy2[rows, idx],
                                        torch.ones(idx.shape, dtype=xy1.dtype, device=xy1.device))
    msac = twoview._msac(fs, xy1[:, None], xy2[:, None], valid[:, None], thr2)
    return torch.where(torch.isfinite(fs).flatten(-2).all(-1), msac, torch.inf).double()


def gaps(k: torch.Tensor, p: torch.Tensor, d: torch.Tensor) -> dict:
    """Relative gaps over the entries finite on all three sides: kp the
    kernel's from the plain version's, pd the plain version's from float64,
    kd the kernel's from float64; ``finite`` the share kept."""
    k, p, d = k.double(), p.double(), d.double()
    fin = torch.isfinite(k) & torch.isfinite(p) & torch.isfinite(d)
    return dict(kp=((k - p).abs() / p)[fin], pd=((p - d).abs() / d)[fin],
                kd=((k - d).abs() / d)[fin], finite=float(fin.double().mean()))


def hypothesis_gaps(xy1, xy2, valid, idx, threshold: float = THR) -> dict:
    """``gaps`` of every hypothesis' MSAC on samples idx [B, H, 8]: the
    kernels (``cuda_twoview.ransac``'s ``msac_out``) against the plain
    helpers in float32 and float64, all on xy1's device."""
    thr2 = threshold * threshold
    mk = torch.empty(idx.shape[:2], device=xy1.device)
    cuda_twoview.ransac(xy1, xy2, valid, threshold, 15, 0.1, sample_idx=idx, msac_out=mk)
    return gaps(mk, _msac_of(xy1, xy2, valid, idx, thr2),
                _msac_of(xy1.double(), xy2.double(), valid, idx, thr2))


def _q(x: torch.Tensor, p: float) -> float:
    return float(torch.quantile(x, p))


def summary(g: dict) -> dict:
    """The quantiles the rules read, for a report line."""
    return {f"{k}_q{int(p * 100)}": _q(g[k], p) for k in ("kp", "pd", "kd") for p in (0.5, 0.9)}


def score_failures(g: dict, tail: bool = True) -> list:
    """What breaks the hypotheses' rule (module docstring); empty if none.
    ``tail=False`` leaves out the 90th percentile of the kernel's gap from
    the plain version, which needs many pairs: each pair's tail is its own,
    and over one pair's 256 hypotheses the two float32 versions' 90th
    percentiles part by half the plain version's gap to float64 (on an
    H100), where over 48 pairs they part by a sixth."""
    out = [] if g["finite"] > 0.99 else [f"finite share {g['finite']:.4f} <= 0.99"]
    for p in (0.5, 0.9):
        kp, pd, kd = _q(g["kp"], p), _q(g["pd"], p), _q(g["kd"], p)
        if not kp <= 0.25 * pd and (tail or p == 0.5):
            out.append(f"q{p}: kernel-plain {kp:.3g} > 0.25 x plain-float64 {pd:.3g}")
        if not kd <= 1.1 * pd:
            out.append(f"q{p}: kernel-float64 {kd:.3g} > 1.1 x plain-float64 {pd:.3g}")
    same = float((g["kp"] <= 1e-4).double().mean())
    if not same >= 0.25:
        out.append(f"share within 1e-4 {same:.3f} < 0.25")
    return out


def lo_case(rng: np.random.Generator, b: int, n: int, device="cpu", **kw):
    """(xy1, xy2, valid, f0, threshold): ``two_view_pairs`` in normalised
    coordinates, the threshold with them, and a start F [B, 3, 3] fitted by
    the plain float32 lanes to 8 distinct planted inliers of each pair."""
    xy1, xy2, valid, truth = (torch.from_numpy(a).to(device)
                              for a in two_view_pairs(rng, b, n, **kw))
    centre = torch.tensor(CENTRE, device=device)
    xy1, xy2 = (xy1 - centre) / FOCAL, (xy2 - centre) / FOCAL
    seed = int(rng.integers(2**31))
    idx = twoview.sample_eight(valid & truth, 1, torch.Generator(device).manual_seed(seed))
    rows = torch.arange(b, device=device)[:, None, None]
    f0 = twoview._fit_fundamental_lanes(xy1[rows, idx], xy2[rows, idx],
                                        torch.ones(idx.shape, device=device))[:, 0]
    return xy1, xy2, valid, f0, THR / FOCAL


def lo_gaps(xy1, xy2, valid, f0, threshold: float, refine=None) -> dict:
    """``gaps`` of the MSAC after the local optimisation from f0: `refine`
    (``cuda_twoview.refine`` by default; anything with its signature and
    result) against ``twoview.local_optimise`` in float32 and float64; and
    ``taken``/``plain_taken``, the shares of pairs whose MSAC fell below the
    start's."""
    thr2 = threshold * threshold
    refine = cuda_twoview.refine if refine is None else refine
    k = refine(xy1, xy2, valid, f0, threshold, 15, 0.1)[4]
    p = twoview.local_optimise(f0, xy1, xy2, valid, thr2)[1]
    d = twoview.local_optimise(f0.double(), xy1.double(), xy2.double(), valid, thr2)[1]
    start = twoview._msac(f0, xy1, xy2, valid, thr2)
    g = gaps(k, p, d)
    g.update(taken=float((k < start).double().mean()),
             plain_taken=float((p < start).double().mean()))
    return g


def lo_failures(g: dict) -> list:
    """What breaks the local optimisation's rule (module docstring)."""
    out = [] if g["finite"] > 0.99 else [f"finite share {g['finite']:.4f} <= 0.99"]
    if not min(g["taken"], g["plain_taken"]) >= 0.9:
        out.append(f"improved {g['taken']:.3f} of pairs, the plain version {g['plain_taken']:.3f}"
                   f" (at least 0.9 each)")
    for p in (0.5, 0.9):
        kd, pd = _q(g["kd"], p), _q(g["pd"], p)
        if not kd <= 3.0 * pd + 1e-7:
            out.append(f"q{p}: after LO kernel-float64 {kd:.3g} > 3 x plain-float64 {pd:.3g}")
    return out
