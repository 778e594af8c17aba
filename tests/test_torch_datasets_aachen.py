"""The port's Aachen, web and debug data sources against the JAX
package's ``training/datasets_aachen.py``, and ``cli/train.py`` fed by
``--data_sources`` and ``--flow_pair_list``.

A small Aachen layout is written under ``tmp_path`` (db and day images,
style-transfer stills, one optical-flow pair), with a revisitop1m-style
web folder and a debug folder. Image lists, tags, pairs and their order
are identical; still and flow pairs are identical arrays (the same
decoder reads the same files). Synthetic warps (W, A, D) draw the same
homography, so flow and mask are identical and the warped image agrees
within ``WARP_TOL`` (``tests/test_torch_training_data.py``: the port
warps with ``grid_sample``, cv2 rounds sample positions to 1/32 px).
"""

import json

import cv2
import numpy as np
import pytest

from sfd2_torch.cli import train as t_cli
from sfd2_torch.training import data as t_data
from sfd2_torch.training import datasets_aachen as t_da
from sfd2_torch.training import flow_pairs as t_fp
from sfd2_tpu.training import data as j_data
from sfd2_tpu.training import datasets_aachen as j_da
from test_torch_training_data import WARP_TOL, texture

H, W = 80, 96


def _write(path, img):
    """A JPEG (PNG for a .png name), whatever the file's extension."""
    path.parent.mkdir(parents=True, exist_ok=True)
    ext = ".png" if path.suffix == ".png" else ".jpg"
    path.write_bytes(cv2.imencode(ext, (img[..., ::-1] * 255).astype(np.uint8))[1].tobytes())


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("sources")
    rng = np.random.default_rng(0)
    aachen = root / "aachen"
    up = aachen / "images_upright"
    for tag in ("1000", "1001", "1002"):
        _write(up / "db" / f"{tag}.jpg", texture(rng, H, W))
    _write(up / "query" / "day" / "q0.jpg", texture(rng, H, W))
    _write(up / "query" / "night" / "q1.jpg", texture(rng, H, W))
    for name in ("1000.jpg.st_0", "1001.jpg.st_3", "9999.jpg.st_0"):  # the last: no db image
        _write(aachen / "style_transfer" / name, texture(rng, H, W))
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    (aachen / "optical_flow" / "flow").mkdir(parents=True)
    (aachen / "optical_flow" / "mask").mkdir(parents=True)
    for a, b in (("1000", "1001"), ("1002", "1000")):
        t_fp.flow_to_png(np.stack([0.5 * xs + 3.25, -0.25 * ys + 1.5], -1),
                         aachen / "optical_flow" / "flow" / f"{a}_{b}.png")
        cv2.imwrite(str(aachen / "optical_flow" / "mask" / f"{a}_{b}.png"),
                    ((xs + ys) % 7 > 0).astype(np.uint8) * 255)
    web = root / "web"
    for folder, name in (("000", "a.jpg"), ("001", "b.png"), ("005", "c.jpg")):
        _write(web / folder / name, texture(rng, H, W))
    for name in ("x.png", "sub/y.png"):
        _write(root / "debug" / name, texture(rng, H, W))
    return root


def _same_pair(got, ref, synthetic=False):
    assert len(got) == len(ref) == 4
    np.testing.assert_array_equal(got[0], ref[0])
    if synthetic:
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=WARP_TOL)
    else:
        np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])


@pytest.mark.parametrize("select", ["db", "day night", "db day night"])
def test_aachen_images_match_jax(roots, select):
    got = t_da.AachenImages(roots / "aachen", select=select)
    ref = j_da.AachenImages(roots / "aachen", select=select)
    assert got.imgs == ref.imgs and len(got) > 0
    for i in range(len(got)):
        assert got.get_tag(i) == ref.get_tag(i) and got.get_key(i) == ref.get_key(i)
        np.testing.assert_array_equal(got.get_image(i), ref.get_image(i))


def test_still_and_flow_pairs_match_jax(roots):
    a = roots / "aachen"
    got = t_da.aachen_style_transfer_pairs(a / "style_transfer", a)
    ref = j_da.aachen_style_transfer_pairs(a / "style_transfer", a)
    assert got.pairs == ref.pairs == [(0, 3), (1, 4)]
    for i in range(len(got)):
        _same_pair(got.get_pair(i), ref.get_pair(i))
    got, ref = t_da.AachenFlowPairs(a / "optical_flow", a), j_da.AachenFlowPairs(a / "optical_flow", a)
    assert got.pairs == ref.pairs
    for i in range(len(got)):
        _same_pair(got.get_pair(i), ref.get_pair(i))
        aflow, mask = got.get_pair(i)[2:]
        assert 0.1 < np.isnan(aflow[..., 0]).mean() < 0.3 and not mask.all()


def test_web_images_and_synthetic_adapter_match_jax(roots):
    got, ref = t_da.RandomWebImages(roots / "web", 0, 1), j_da.RandomWebImages(roots / "web", 0, 1)
    assert got.imgs == ref.imgs == ["000/a.jpg", "001/b.png"]
    for i in range(len(got)):
        np.testing.assert_array_equal(got.get_image(i), ref.get_image(i))
    ta = t_da.SyntheticPairAdapter(got, crop=48, seed=3)
    ja = j_da.SyntheticPairAdapter(ref, crop=48, seed=3)
    for i in range(len(ta)):
        _same_pair(ta.get_pair(i), ja.get_pair(i), synthetic=True)


def test_build_data_source_matches_jax(roots):
    kw = dict(crop=48, aachen_root=roots / "aachen", web_root=roots / "web",
              debug_root=roots / "debug", seed=1)
    got, ref = t_da.build_data_source("WASFD", **kw), j_da.build_data_source("WASFD", **kw)
    assert len(got) == len(ref) == 3 + 3 + 2 + 2 + 2
    assert list(got.offsets) == list(ref.offsets)
    synthetic = set(range(3)) | set(range(3, 6)) | {10, 11}
    for i in range(len(got)):
        _same_pair(got.get_pair(i), ref.get_pair(i), synthetic=i in synthetic)
    assert isinstance(t_da.build_data_source("F", **kw), t_da.AachenFlowPairs)
    with pytest.raises(ValueError, match="'Q'"):
        t_da.build_data_source("Q", **kw)


def test_pair_loader_over_the_sources_matches_jax(roots):
    kw = dict(crop=48, aachen_root=roots / "aachen", debug_root=roots / "debug")
    got = t_data.PairLoader(t_da.build_data_source("SFD", **kw),
                            t_data.PrecomputedPairBuilder(crop=48), batch_size=2, seed=4, workers=2)
    ref = j_data.PairLoader(j_da.build_data_source("SFD", **kw),
                            j_data.PrecomputedPairBuilder(crop=48), batch_size=2, seed=4, workers=2)
    bg, br = list(got.epoch(1)), list(ref.epoch(1))
    assert len(bg) == len(br) == 3
    for a, b in zip(bg, br):
        for k in ("image1", "gray1", "raw1", "mask", "aflow"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["image2"], b["image2"], rtol=0, atol=WARP_TOL / 0.225)


def test_train_cli_from_data_sources_and_flow_pair_list(roots, tmp_path):
    a = roots / "aachen"
    (tmp_path / "pairs.txt").write_text(
        "images_upright/db/1000.jpg images_upright/db/1001.jpg "
        "optical_flow/flow/1000_1001.png optical_flow/mask/1000_1001.png\n"
        "images_upright/db/1002.jpg images_upright/db/1000.jpg "
        "optical_flow/flow/1002_1000.png optical_flow/mask/1002_1000.png\n")
    common = ["--epochs", "1", "--iters_per_epoch", "1", "--bs", "2", "--R", "72",
              "--workers", "1", "--save_dir", str(tmp_path / "runs"), "--device", "cpu"]
    runs = {
        "sources": ["--data_sources", "SFD", "--aachen_root", str(a),
                    "--debug_root", str(roots / "debug")],
        "flows": ["--flow_pair_list", str(tmp_path / "pairs.txt"), "--pair_image_root", str(a)],
    }
    for name, args in runs.items():
        trainer = t_cli.main(common + args + ["--run_name", name])
        assert trainer.state.step == 1
        rec = json.loads((tmp_path / "runs" / name / "metrics.jsonl").read_text().splitlines()[0])
        assert np.isfinite(rec["loss"]) and "seg_det_loss" not in rec  # no teacher: seg off
        args_json = json.loads((tmp_path / "runs" / name / "args.json").read_text())
        assert args_json["R"] == 72
