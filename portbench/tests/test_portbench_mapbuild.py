"""The map-build driver on a tiny cell on the CPU (the matchers' plain
versions): it prints the contract line, traced and untraced; with the
timed path broken underneath (verification skipped, a match altered where
the matcher writes it) the same run reads ``correct`` false. The
covisibility pair rule against a direct count, and the verification
judge on hand-made pairs."""

import collections
import copy

import numpy as np
import pytest

from portbench import control, harness
from portbench.covis import pairs_from_covisibility
from portbench.reference.mapbuild import given_matches, verification_counts

import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def mapbuild_cell():
    """The cell at 40 DB images of 512 keypoints of width 32, a few per cent
    of each pair's mutual matches false, 32 pairs a call."""
    cell = harness.resolve(harness.load_manifest(), "aachen-mapbuild-covis20")
    cell.config = copy.deepcopy(cell.config)
    cell.config["map"].update(n_db=40, keypoints=512, descriptor_dim=32, points_per_db_image=20)
    cell.mix = dict(cell.mix, chunk_pairs=32, warmup_pairs=16, check_pairs=16,
                    verify=dict(cell.mix["verify"], max_matches=512))
    return cell


def test_mapbuild_driver_prints_the_line():
    cell = mapbuild_cell()
    line = tiny.run_line(cell, seconds=3.0)
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell.limits)
    assert set(line["metrics"]) == {"map_pairs_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert line["attempted"] == line["info"]["calls"] * cell.mix["chunk_pairs"]
    assert line["info"]["pairs_checked"] == cell.mix["check_pairs"]
    assert line["info"]["verified_pair_share"] > 0.9


def test_mapbuild_driver_traced():
    cell = mapbuild_cell()
    cell.mix = dict(cell.mix, trace_from=0.0, trace_share=0.9)
    line = tiny.run_line(cell, seconds=4.0, trace=True)
    assert line["correct"] is True, line["checks"]
    assert {"match_ms.mapbuild", "verify_ms.mapbuild", "mfu.mapbuild"} <= set(line["metrics"])
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert "window_s" in line["device"] and "breakdown" in line
    assert not harness.forbidden_modules()


def test_verification_skipped(monkeypatch):
    """Every match the verification is given kept, for every pair."""
    import sfd2_torch.sfm.pipeline as pipeline

    def skipped(features, matches, pairs, cfg=None, max_matches=1024, device="cuda"):
        out = []
        for n0, n1 in pairs:
            m, _ = matches.read(n0, n1)
            src = np.nonzero(m >= 0)[0]
            out.append((n0, n1, np.stack([src, m[src]], 1)[:max_matches]))
        return out

    monkeypatch.setattr(pipeline, "geometric_verification", skipped)
    line = tiny.run_line(mapbuild_cell())
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["verified_outlier_share"]["value"] > checks["verified_outlier_share"]["limit"]


def test_match_altered(monkeypatch):
    """One match of every pair moved to the next keypoint where the matcher writes it."""
    from sfd2_torch.io.feature_store import MatchStore

    inner = MatchStore.write

    def altered(self, name0, name1, matches0, scores0=None):
        m = np.array(matches0)
        hit = np.nonzero(m >= 0)[0][:1]
        m[hit] = (m[hit] + 1) % 512
        return inner(self, name0, name1, m, scores0)

    monkeypatch.setattr(MatchStore, "write", altered)
    line = tiny.run_line(mapbuild_cell())
    assert line["correct"] is False
    assert line["checks"]["match_gap"]["value"] > line["checks"]["match_gap"]["limit"]


@pytest.mark.parametrize("which,points", [("tf32", 40), ("unverified", 20), ("half", 20),
                                          ("few16", 20)])
def test_controls_fail_at_a_tiny_size(which, points):
    """TF32 moves a match only where two candidates nearly tie: at this size
    that takes more points to a view than the others need."""
    cell = mapbuild_cell()
    cell.config["map"]["points_per_db_image"] = points
    out = control.judge(cell, 2**33 + 3, "cpu", which=which)
    assert out["correct"] is False, out["checks"]
    assert set(out["checks"]) == set(harness.resolve(
        harness.load_manifest(), "aachen-mapbuild-covis20").limits)


def test_program_readings_pass_at_a_tiny_size():
    out = control.judge(mapbuild_cell(), 2**33 + 4, "cpu", program=True)
    assert out["correct"] is True, out["checks"]
    assert out["info"]["pairs_checked"] == 16


def test_covisibility_pairs_follow_the_counting_rule():
    """hloc's rule counted directly: per image, the images sharing the most
    points, most first, the lower index first among equal counts; none
    that share nothing."""
    rng = np.random.default_rng(3)
    n, k = 12, 30
    db_point = np.full((n, k), -1)
    for i in range(n):
        seen = rng.choice(np.arange(i * 4, i * 4 + 60), rng.integers(5, k + 1), replace=False)
        db_point[i, :len(seen)] = seen
    db_point[5] = -1  # an image that observes nothing is paired with none
    got = pairs_from_covisibility(db_point, 4, "cpu")
    want = []
    for i in range(n):
        counts = collections.Counter()
        for j in range(n):
            if j != i:
                counts[j] = len(set(db_point[i][db_point[i] >= 0]) & set(db_point[j]))
        top = sorted((j for j in counts if counts[j] > 0), key=lambda j: (-counts[j], j))[:4]
        want += [(i, j) for j in top]
    assert [tuple(r) for r in got.tolist()] == want
    assert not any(5 in r for r in want)


def test_verification_judge_on_hand_made_pairs():
    point0 = np.array([7, 8, 9, -1, 11])
    point1 = np.array([9, 7, 8, 11, 5])
    m = np.array([1, 2, 0, -1, 4])  # 0-1, 1-2, 2-0 true; 4-4 false
    given = given_matches(m, False, 3)
    assert given.tolist() == [[0, 1], [1, 2], [2, 0]]
    assert given_matches(np.array([2, 0, 1, 4, -1]), True, 8).tolist() == \
        [[0, 1], [1, 2], [2, 0], [4, 3]]
    kept = np.array([[0, 1], [4, 4]])
    assert verification_counts(point0, point1, given_matches(m, False, 8), kept) == (2, 1, 3, 2)
    assert verification_counts(point0, point1, given, None) == (0, 0, 3, 3)
