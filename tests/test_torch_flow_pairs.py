"""The port's flow-PNG codec, image reader and pair datasets against the
JAX package's ``training/flow_pairs.py``.

``utils/image_io.py`` reads and writes through OpenCV, or PIL without
OpenCV; both libraries are installed here, and every test runs with each
(``backend``). Flows are written with fractional and out-of-range values:
the stored fixed-point flow, the PNG bytes decoded by the other package,
and the datasets' pairs, flows, masks and order are identical (exact: no
arithmetic differs). Without either library a read raises an
``ImportError`` that names the file.
"""

import numpy as np
import pytest
from PIL import Image

from sfd2_torch.training import flow_pairs as t_fp
from sfd2_torch.training.data import ArrayDataset
from sfd2_torch.utils import image_io
from sfd2_tpu.training import flow_pairs as j_fp


@pytest.fixture(params=["cv2", "pil"])
def backend(request, monkeypatch):
    lib = image_io._library()
    if request.param == "pil":
        from PIL import Image as pil_image

        lib = ("pil", pil_image)
    assert lib[0] == request.param
    monkeypatch.setattr(image_io, "_library", lambda: lib)
    return request.param


def _flow(rng, h=40, w=52):
    flow = rng.normal(size=(h, w, 2)).astype(np.float32) * 30
    flow[0, 0] = (3000.0, -3000.0)  # clipped to int16 / 16
    flow[1, 1] = (0.03125, -0.03125)  # half a step: round half to even
    return flow


def test_flow_png_round_trips_between_packages(backend, tmp_path):
    flow = _flow(np.random.default_rng(0))
    q_port = t_fp.flow_to_png(flow, tmp_path / "port.png")
    q_jax = j_fp.flow_to_png(flow, tmp_path / "jax.png")
    np.testing.assert_array_equal(q_port, q_jax)
    assert np.abs(q_port - flow)[2:].max() <= 1 / 32  # 1/16-px steps
    for name in ("port.png", "jax.png"):
        got = t_fp.png_to_flow(tmp_path / name)
        np.testing.assert_array_equal(got, j_fp.png_to_flow(tmp_path / name))
        np.testing.assert_array_equal(got, q_jax)
    packed = np.asarray(Image.open(tmp_path / "port.png"))
    assert packed.dtype == np.uint8 and packed.shape == (40, 52, 4)


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_image_io_reads_and_writes_like_pil(backend, tmp_path, channels):
    rng = np.random.default_rng(1)
    shape = (23, 31) if channels is None else (23, 31, channels)
    a = rng.integers(0, 256, size=shape, dtype=np.uint8)
    image_io.write_png(tmp_path / "a.png", a)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), a)
    Image.fromarray(a).save(tmp_path / "b.png")
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "b.png", unchanged=True), a)
    rgb = image_io.read_image(tmp_path / "b.png")
    ref = np.asarray(Image.open(tmp_path / "b.png").convert("RGB"))
    assert rgb.shape == (23, 31, 3)
    np.testing.assert_array_equal(rgb, ref)
    np.testing.assert_array_equal(image_io.read_rgb(tmp_path / "b.png"),
                                  ref.astype(np.float32) / 255.0)


def test_image_io_names_the_file_without_a_library(tmp_path, monkeypatch):
    monkeypatch.setattr(image_io, "_library", lambda: None)
    with pytest.raises(ImportError, match="x.jpg"):
        image_io.read_image(tmp_path / "x.jpg")
    with pytest.raises(ImportError, match="y.png"):
        image_io.write_png(tmp_path / "y.png", np.zeros((2, 2), np.uint8))


def test_image_io_missing_file(backend, tmp_path):
    with pytest.raises(FileNotFoundError):
        image_io.read_image(tmp_path / "none.png")
    (tmp_path / "bad.png").write_bytes(b"not an image")
    with pytest.raises((FileNotFoundError, OSError)):
        image_io.read_image(tmp_path / "bad.png")


def test_still_pairs_match_jax():
    rng = np.random.default_rng(2)
    images = [rng.random((30, 40, 3)).astype(np.float32) for _ in range(3)]
    images.append(rng.random((60, 60, 3)).astype(np.float32))  # scaled identity flow
    base = ArrayDataset(images)
    for pairs in (None, [(0, 1), (2, 3), (3, 3)]):
        got, ref = t_fp.StillPairDataset(base, pairs), j_fp.StillPairDataset(base, pairs)
        assert len(got) == len(ref)
        for i in range(len(got)):
            for a, b in zip(got.get_pair(i), ref.get_pair(i)):
                np.testing.assert_array_equal(a, b)


def test_flow_pair_dataset_matches_jax(backend, tmp_path):
    rng = np.random.default_rng(3)
    entries = []
    for i in range(3):
        for j in (0, 1):
            img = (rng.random((40, 52, 3)) * 255).astype(np.uint8)
            image_io.write_png(tmp_path / f"im{i}_{j}.png", img)
        j_fp.flow_to_png(_flow(rng), tmp_path / f"flow{i}.png")
        mask = (rng.random((40, 52)) < 0.8).astype(np.uint8) * 255
        if i == 1:  # an RGB-saved mask
            mask = np.repeat(mask[..., None], 3, -1)
        Image.fromarray(mask).save(tmp_path / f"mask{i}.png")
        entries.append((f"im{i}_0.png", f"im{i}_1.png", f"flow{i}.png", f"mask{i}.png"))
    got, ref = t_fp.FlowPairDataset(tmp_path, entries), j_fp.FlowPairDataset(tmp_path, entries)
    assert len(got) == len(ref) == 3
    for i in range(3):
        g, r = got.get_pair(i), ref.get_pair(i)
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
        assert np.isnan(g[2][~g[3]]).all() and np.isfinite(g[2][g[3]]).all()
    bad = [("im0_0.png", "im0_1.png", "flow0.png", "mask0.png")]
    Image.fromarray(np.zeros((10, 10), np.uint8)).save(tmp_path / "mask0.png")
    with pytest.raises(ValueError, match="does not"):
        t_fp.FlowPairDataset(tmp_path, bad).get_pair(0)
