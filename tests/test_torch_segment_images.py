"""``cli/segment_images.py`` against the JAX package's CLI.

Both CLIs label the same folder (a nested image, a flat one, an
unreadable file) with the same seeded ``ConvNeXtUPerNet(arch="tiny")``
(``tests/test_torch_seg_teacher.py``'s model, mmseg names read by the
JAX converter), slide (crop 64, stride 43) and whole-image mode. Both
write the same files at the same relative paths, and their labels agree
on ≥ 99 % of pixels (the logits within 1e-4 of their largest magnitude,
so only near-ties flip); ``LabelDirTeacher`` reads the port's maps back.
The port's ``--checkpoint`` path gives exactly `segment_folder`'s maps.
"""

import functools

import cv2
import numpy as np
import pytest
import torch

from sfd2_torch.cli import segment_images as t_cli
from sfd2_torch.models import upernet as t_up
from sfd2_torch.training.seg_teacher import LabelDirTeacher
from sfd2_tpu.cli import segment_images as j_cli
from sfd2_tpu.models import upernet as j_up
from test_torch_seg_teacher import KW, jax_vars, port_model  # noqa: F401  (fixtures)

torch.set_num_threads(2)

NAMES = ["db/1000.png", "q.png"]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg_images")
    rng = np.random.default_rng(8)
    for name in NAMES:
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(root / name), (rng.random((96, 128, 3)) * 255).astype(np.uint8))
    (root / "broken.jpg").write_bytes(b"not a jpeg")
    return root


def _labels(root):
    return {p.relative_to(root).as_posix(): cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            for p in sorted(root.rglob("*.png"))}


@pytest.mark.parametrize("mode", ["slide", "whole"])
def test_segment_images_matches_jax(images, tmp_path, port_model, jax_vars,  # noqa: F811
                                    monkeypatch, mode):
    cfg = dict(crop=64, stride=43, mode=mode)
    jax_segmentor = j_up.Segmentor
    monkeypatch.setattr(j_up, "Segmentor", lambda variables, config: jax_segmentor(
        jax_vars, j_up.SegmentorConfig(**cfg), model=j_up.ConvNeXtUPerNet(**KW)))
    j_cli.main(["--image_dir", str(images), "--out_dir", str(tmp_path / "jax"), "--mode", mode])
    seg = t_up.Segmentor(port_model, t_up.SegmentorConfig(**cfg), device="cpu")
    assert t_cli.segment_folder(seg, images, tmp_path / "port") == 2
    assert t_cli.segment_folder(seg, images, tmp_path / "port") == 0  # existing maps kept
    got, ref = _labels(tmp_path / "port"), _labels(tmp_path / "jax")
    assert sorted(got) == sorted(ref) == NAMES
    for name in NAMES:
        assert got[name].dtype == np.uint8 and got[name].shape == (96, 128)
        assert got[name].min() >= 1
        assert (got[name] == ref[name]).mean() >= 0.99
        np.testing.assert_array_equal(
            LabelDirTeacher(tmp_path / "port").label_image(name.replace(".png", ".jpg"),
                                                           (96, 128)), got[name])


def test_segment_images_cli_reads_a_checkpoint(images, tmp_path, port_model,  # noqa: F811
                                               monkeypatch):
    torch.save({"state_dict": port_model.state_dict()}, tmp_path / "seg.pth")
    monkeypatch.setattr(t_up, "ConvNeXtUPerNet", functools.partial(t_up.ConvNeXtUPerNet, **KW))
    monkeypatch.setattr(t_up, "SegmentorConfig", functools.partial(
        t_up.SegmentorConfig, crop=64, stride=43))
    n = t_cli.main(["--image_dir", str(images), "--out_dir", str(tmp_path / "cli"),
                    "--checkpoint", str(tmp_path / "seg.pth"), "--device", "cpu"])
    assert n == 2
    seg = t_up.Segmentor(port_model, t_up.SegmentorConfig(), device="cpu")
    t_cli.segment_folder(seg, images, tmp_path / "fn")
    got, ref = _labels(tmp_path / "cli"), _labels(tmp_path / "fn")
    assert sorted(got) == NAMES
    for name in NAMES:
        np.testing.assert_array_equal(got[name], ref[name])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_cli.main(["--image_dir", str(images), "--out_dir", str(tmp_path / "x"),
                        "--checkpoint", str(tmp_path / "seg.pth")])


def test_label_dir_pairs_put_cropped_labels_in_the_batches(tmp_path):
    """Label maps written by ``segment_folder`` reach the loader's
    batches as ``seg1``, cropped to img1's window: the image encodes its
    own pixel coordinates, so the window can be read back from ``raw1``."""
    from sfd2_torch.training.data import PairLoader, PrecomputedPairBuilder
    from sfd2_torch.training.flow_pairs import StillPairDataset
    from sfd2_torch.training.data import ArrayDataset
    from sfd2_torch.training.seg_teacher import LabelDirPairs

    h, w = 70, 90
    ys, xs = np.mgrid[0:h, 0:w]
    images = [np.stack([ys / 255.0, xs / 255.0, np.full((h, w), i / 255.0)], -1).astype(np.float32)
              for i in range(3)]
    labels = [((ys * 7 + xs * 3 + i) % 150 + 1).astype(np.uint8) for i in range(3)]

    class Fixed:  # a segmentor whose labels are known
        def __init__(self):
            self.calls = 0

        def evaluate(self, rgb):
            i = int(rgb[0, 0, 2])
            self.calls += 1
            return labels[i].astype(np.int32) - 1

    for i, img in enumerate(images):
        cv2.imwrite(str(tmp_path / f"im{i}.png"), (img[..., ::-1] * 255).round().astype(np.uint8))
    assert t_cli.segment_folder(Fixed(), tmp_path, tmp_path / "labels") == 3
    pairs = LabelDirPairs(StillPairDataset(ArrayDataset(images)),
                          LabelDirTeacher(tmp_path / "labels"), [f"im{i}.png" for i in range(3)])
    batch = next(iter(PairLoader(pairs, PrecomputedPairBuilder(crop=48), batch_size=3,
                                 seed=2, workers=1).epoch(0)))
    assert batch["seg1"].shape == (3, 48, 48) and batch["seg1"].dtype == np.int32
    for raw, seg in zip(batch["raw1"], batch["seg1"]):
        i = int(round(raw[0, 0, 2] * 255))
        y0, x0 = int(round(raw[0, 0, 0] * 255)), int(round(raw[0, 0, 1] * 255))
        np.testing.assert_array_equal(seg, labels[i][y0:y0 + 48, x0:x0 + 48])
    with pytest.raises(ValueError, match="names"):
        LabelDirPairs(StillPairDataset(ArrayDataset(images)), LabelDirTeacher(tmp_path), ["a"])
