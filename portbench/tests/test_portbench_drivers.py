"""Each driver runs a tiny cell on the CPU (the kernels' plain versions)
and prints the one contract line; with the timed path broken underneath,
the same run reads ``correct`` false.

The faults a cell can have: an answer altered where it is produced (a
served pose, a match of the matcher, an image's descriptors or scores) and half of
a batch left out (its images given the other half's features). The
exchange between chips and a step that keeps its state are not faults of
these cells: they run on one chip and train nothing.
"""

import numpy as np
import pytest

import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def check_line(line, cell, trace=False):
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell.limits)
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["count"] == 1


@pytest.mark.parametrize("name", ["aachen-serve-c4", "robotcar-serve-c1"])
def test_serve_driver_prints_the_line(name):
    cell = tiny.serve_cell(name)
    line = tiny.run_line(cell, seconds=12.0)  # a CPU request takes seconds
    check_line(line, cell)
    assert line["correct"] is True and line["failed"] == 0
    assert line["info"]["requests_checked"] >= 1


def test_serve_driver_traced():
    cell = tiny.serve_cell()
    line = tiny.run_line(cell, seconds=3.0, trace=True)
    check_line(line, cell, trace=True)
    assert {"service_overhead_ms.query", "match_ms.query", "pnp_ms.query"} <= set(line["metrics"])
    assert "window_s" in line["device"] and "breakdown" in line


def test_extract_driver_prints_the_line():
    cell = tiny.extract_cell()
    line = tiny.run_line(cell)
    check_line(line, cell)
    assert line["correct"] is True and line["info"]["images_checked"] >= 1


def test_extract_driver_traced():
    cell = tiny.extract_cell()
    line = tiny.run_line(cell, trace=True)
    check_line(line, cell, trace=True)
    assert "mfu.extract" in line["metrics"]


def test_served_pose_altered(monkeypatch):
    from sfd2_torch.serving.server import LocalizationService

    inner = LocalizationService.localize

    def altered(self, body):
        out = inner(self, body)
        out["tvec"] = [v + 0.1 for v in out["tvec"]]
        return out

    monkeypatch.setattr(LocalizationService, "localize", altered)
    line = tiny.run_line(tiny.serve_cell())
    assert line["correct"] is False
    assert line["checks"]["pose_t_gap_m"]["value"] > line["checks"]["pose_t_gap_m"]["limit"]


def test_match_altered(monkeypatch):
    from sfd2_torch.localization.engine import LocalizationEngine

    inner = LocalizationEngine._match_query_to_dbs

    def altered(self, *args, **kwargs):
        m = inner(self, *args, **kwargs).copy()
        hit = np.nonzero(m[0] >= 0)[0][:1]
        m[0, hit] = (m[0, hit] + 1) % m.shape[1]
        return m

    monkeypatch.setattr(LocalizationEngine, "_match_query_to_dbs", altered)
    line = tiny.run_line(tiny.serve_cell())
    assert line["correct"] is False
    assert line["checks"]["match_gap"]["value"] > line["checks"]["match_gap"]["limit"]


def test_descriptors_altered(monkeypatch):
    from sfd2_torch.io.feature_store import ImageFeatures
    from sfd2_torch.pipeline.extract import Extractor

    inner = Extractor.extract_batch

    def altered(self, images, label_maps=None):
        out = inner(self, images, label_maps)
        f = out[0]
        d = f.descriptors.copy()
        d[:, 0] += 0.2
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return [ImageFeatures(f.keypoints, d, f.scores, f.image_size, f.labels)] + out[1:]

    monkeypatch.setattr(Extractor, "extract_batch", altered)
    line = tiny.run_line(tiny.extract_cell())
    assert line["correct"] is False


def test_half_of_the_batch_left_out(monkeypatch):
    from sfd2_torch.pipeline.extract import Extractor

    inner = Extractor.extract_batch

    def half(self, images, label_maps=None):
        out = inner(self, images[: len(images) // 2], label_maps)
        return out + out[: len(images) - len(out)]

    monkeypatch.setattr(Extractor, "extract_batch", half)
    cell = tiny.extract_cell()
    cell.mix["check_images"] = 10**6  # every kept image, so that a second half is checked
    line = tiny.run_line(cell)
    assert line["correct"] is False
    assert line["checks"]["kp_miss_share"]["value"] > line["checks"]["kp_miss_share"]["limit"]


def test_scores_scaled(monkeypatch):
    """Every score halved, the ranking kept (a stability factor applied
    twice): the keypoints and descriptors agree, the logit gap does not."""
    from sfd2_torch.io.feature_store import ImageFeatures
    from sfd2_torch.pipeline.extract import Extractor

    inner = Extractor.extract_batch

    def scaled(self, images, label_maps=None):
        return [ImageFeatures(f.keypoints, f.descriptors, f.scores * 0.5, f.image_size, f.labels)
                for f in inner(self, images, label_maps)]

    monkeypatch.setattr(Extractor, "extract_batch", scaled)
    line = tiny.run_line(tiny.extract_cell())
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["score_logit_gap"]["value"] > checks["score_logit_gap"]["limit"]
    assert checks["desc_gap"]["value"] <= checks["desc_gap"]["limit"]
