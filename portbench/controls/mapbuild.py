"""Map-build cells (float32 matching, F-RANSAC at the mix's threshold).

Every control answers the pairs a run's check would sample from its
first call (the seed's start, ``chunk_pairs`` pairs), judged by the
driver's ``verify``:

* ``tf32``: the reference matcher in K2's place, every product of TF32
  operands summed in float32; the program verifies its matches.
* ``unverified``: the program's matches, verification skipped: every
  match it would be given is kept.
* ``loose4``: the program with verification's threshold four times the
  mix's.
* ``half``: the program with half of the pairs left out of
  verification: the second half of the sample keeps nothing.
* ``few16``: the program with F-RANSAC's work cut, the way a careless
  speed-up would cut it: 16 eight-point hypotheses a pair in place of
  2,048, and no local optimisation of the best.

``program`` gives the program's own readings of that first call, run as
the window runs it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from portbench.controls import full_precision
from portbench.reference.mapbuild import given_matches
from portbench.reference.match import mutual_matches, similarities

CONTROLS = ("tf32", "unverified", "loose4", "half", "few16")
FEW_HYPOTHESES = 16


@contextlib.contextmanager
def few_hypotheses():
    """``geometric_verification`` with F-RANSAC cut to FEW_HYPOTHESES
    hypotheses a pair and the best one's MSAC inliers, not refined."""
    from sfd2_torch.sfm import pipeline, twoview

    def ransac(xy1, xy2, valid, threshold=4.0, generator=None, num_hypotheses=2048,
               min_inliers=15, min_inlier_ratio=0.1):
        b, thr2 = xy1.shape[0], threshold * threshold
        idx = twoview.sample_eight(valid, FEW_HYPOTHESES, generator)
        rows = torch.arange(b, device=xy1.device)[:, None, None]
        fs = twoview._fit_fundamental_lanes(xy1[rows, idx], xy2[rows, idx],
                                            torch.ones(idx.shape, dtype=xy1.dtype,
                                                       device=xy1.device))
        msac = twoview._msac(fs, xy1[:, None], xy2[:, None], valid[:, None], thr2)
        msac = torch.where(torch.isfinite(fs).flatten(-2).all(-1), msac, torch.inf)
        f = fs[torch.arange(b, device=xy1.device), torch.argmin(msac, dim=-1)]
        inliers = (twoview.sampson_error(f, xy1, xy2) <= thr2) & valid
        num = inliers.sum(-1).to(torch.int32)
        ratio = num.float() / torch.clamp(valid.sum(-1), min=1).float()
        return twoview.TwoViewResult(f, inliers, num, (num >= min_inliers)
                                     & (ratio >= min_inlier_ratio))

    inner = pipeline.verify_fundamental_ransac
    pipeline.verify_fundamental_ransac = ransac
    try:
        yield
    finally:
        pipeline.verify_fundamental_ransac = inner


def first_call(cell, seed: int, device):
    """(driver, scene, features, the first call's rows, the positions a
    check samples from it)."""
    mapbuild = cell.driver()
    scene, features, pairs = mapbuild.setup(cell, seed, device)
    rows = mapbuild.take(pairs, mapbuild.start_of(pairs, seed), cell.mix["chunk_pairs"])
    check = cell.mix["check_pairs"]
    pos = mapbuild.keep_rng(seed).choice(len(rows), min(check, len(rows)), replace=False)
    return mapbuild, scene, features, rows, pos


def program(cell, seed: int, device) -> dict:
    """The compared numbers of the window's first call, on the seed's scene."""
    mapbuild, scene, features, rows, pos = first_call(cell, seed, device)
    from sfd2_torch.pipeline.match import match_pairs
    from sfd2_torch.sfm.pipeline import geometric_verification

    mcfg, tcfg, max_matches = mapbuild.configs(cell)
    store, written = mapbuild.match_store()
    call = mapbuild.names(rows)
    with full_precision(False):  # the program runs with the flags a run's window has
        match_pairs(features, call, store, mcfg, device=device)
        got = {(n0, n1): inl for n0, n1, inl in
               geometric_verification(features, store, call, tcfg, max_matches, device=device)}
    kept = [(rows[p], (store, written), got.get(call[p])) for p in pos]
    ctx = dict(cell=cell, seed=seed, device=device)
    return mapbuild.verify(ctx, scene, mapbuild.program_answers(kept, seed, len(kept)))


def control(cell, seed: int, device, which: str) -> dict:
    """The compared numbers of control `which` (module docstring)."""
    if which not in CONTROLS:
        raise ValueError(f"unknown control {which!r}; known: {CONTROLS}")
    mapbuild, scene, features, rows, pos = first_call(cell, seed, device)
    from sfd2_torch.pipeline.match import match_pairs
    from sfd2_torch.sfm.pipeline import geometric_verification

    mcfg, tcfg, max_matches = mapbuild.configs(cell)
    rows = rows[np.sort(pos)]
    call = mapbuild.names(rows)
    store, written = mapbuild.match_store()
    dev = torch.device(device)
    cols = torch.arange(scene.size.kp, device=dev)
    if which == "tf32":
        for (i0, i1), (n0, n1) in zip(rows, call):
            q = torch.from_numpy(np.ascontiguousarray(scene.db_desc[i0].T)).to(dev)
            bank = torch.from_numpy(np.ascontiguousarray(scene.db_desc[i1].T)).to(dev)
            s = similarities(q, bank[None], cols < int(scene.db_nv[i0]),
                             (cols < int(scene.db_nv[i1]))[None], "tf32")
            m = mutual_matches(s)[0].cpu().numpy()[:int(scene.db_nv[i0])]
            store.write(n0, n1, m.astype(np.int32), np.zeros(len(m), np.float32))
    else:
        with full_precision(False):
            match_pairs(features, call, store, mcfg, device=device)
    if which == "loose4":
        tcfg = dataclasses.replace(tcfg, verify_threshold=4 * tcfg.verify_threshold)
    cut = few_hypotheses() if which == "few16" else contextlib.nullcontext()
    with full_precision(False), cut:
        verified = geometric_verification(features, store, call, tcfg, max_matches,
                                          device=device)
    got = {(n0, n1): inl for n0, n1, inl in verified}
    kept = [(row, (store, written), got.get(name)) for row, name in zip(rows, call)]
    answers = mapbuild.program_answers(kept, seed, len(kept))
    if which == "unverified":
        answers = [(i0, i1, rev, m, given_matches(m, rev, max_matches))
                   for i0, i1, rev, m, _ in answers]
    elif which == "half":
        half = len(answers) // 2
        answers = answers[:half] + [(*a[:4], None) for a in answers[half:]]
    ctx = dict(cell=cell, seed=seed, device=device)
    return mapbuild.verify(ctx, scene, answers)
