"""The port's multi-scale and labelled extraction against the JAX package's.

Both ``Extractor``s run the full-width ResSegNetV2 in float32 on the same
Flax-initialised weights (randomised BN statistics) at small image sizes;
the JAX one with its fused stem, as the port always runs. Per image the
keypoint sets must be identical and, keypoint by keypoint, descriptors and
scores within 1e-5 and labels equal (the rows may come in another order:
the cross-scale merge sorts scores that differ by float32 rounding, as
``np.argsort`` in both packages). The labelled-first top-K of
``ops/extract.py`` is held to the JAX op on random NMS maps, exactly; the
label chain of ``tests/test_label_chain.py`` (mask files →
``extract_to_store(mask_dir)`` → labels in the store → NNML matching),
the presets, ``auto_scales``, the CLI beside the JAX CLI on a reference
``.pth`` the test writes itself, and the host helpers of the slice
(``nms_fast_host``, ``camera_depths``, ``camera_from_exif``) too.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.cli import extract_features as t_cli
from sfd2_torch.geometry.cameras import camera_depths
from sfd2_torch.io.colmap_model import camera_from_exif
from sfd2_torch.io.feature_store import FeatureStore, MatchStore
from sfd2_torch.models.convert import convert_checkpoint, state_dict_from_flax
from sfd2_torch.models.sfd2 import ResSegNetV2 as TorchResSegNetV2
from sfd2_torch.ops.extract import extract_keypoints
from sfd2_torch.ops.nms import nms_fast_host
from sfd2_torch.pipeline import extract as textract
from sfd2_torch.pipeline.match import MatchConfig, match_pairs
from sfd2_tpu.cli import extract_features as j_cli
from sfd2_tpu.geometry.cameras import camera_depths as jcamera_depths
from sfd2_tpu.io.colmap_model import camera_from_exif as jcamera_from_exif
from sfd2_tpu.io.feature_store import FeatureStore as JFeatureStore
from sfd2_tpu.models.convert import convert_checkpoint as jconvert_checkpoint
from sfd2_tpu.models.sfd2 import ResSegNetV2
from sfd2_tpu.ops.extract import extract_keypoints as jextract_keypoints
from sfd2_tpu.ops.nms import nms_fast_host as jnms_fast_host
from sfd2_tpu.pipeline import extract as jextract

torch.set_num_threads(2)

K = 200


def _textured(rng, h, w):
    img = np.zeros((h, w, 3), np.float32)
    for cell, wgt in ((16, 0.6), (4, 0.4)):
        base = rng.random((-(-h // cell), -(-w // cell), 3)).astype(np.float32)
        img += wgt * np.kron(base, np.ones((cell, cell, 1), np.float32))[:h, :w]
    return img


def _label_map(h, w, ids=(5, 3)):
    lab = np.zeros((h, w), np.int32)
    lab[: h // 8, : w // 6] = ids[0]
    lab[h // 2:, : w // 12] = ids[1]
    return lab


@pytest.fixture(scope="module")
def variables():
    rng = np.random.default_rng(0)
    model = ResSegNetV2(require_stability=True)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.3 if p[-1].key == "mean"
                      else rng.random(size=a.shape) + 0.5).astype(np.float32),
        v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def _extractors(variables, **conf):
    conf = dict(max_keypoints=K, bf16=False, **conf)
    jex = jextract.Extractor(variables, jextract.ExtractionConfig(**conf, fused_stem=True))
    tex = textract.Extractor(state_dict_from_flax(variables), textract.ExtractionConfig(**conf),
                             device="cpu")
    return jex, tex


def _same_features(f_t, f_j, with_labels):
    """Identical keypoint sets; per keypoint descriptors and scores within
    1e-5, labels equal."""
    key = lambda f: {tuple(p): i for i, p in enumerate(f.keypoints.tolist())}  # noqa: E731
    kt, kj = key(f_t), key(f_j)
    assert len(kt) == len(f_t.keypoints) and len(kj) == len(f_j.keypoints)
    assert set(kt) == set(kj) and len(kt) > K // 2
    it = [kt[p] for p in sorted(kj)]
    ij = [kj[p] for p in sorted(kj)]
    np.testing.assert_allclose(f_t.descriptors[it], f_j.descriptors[ij], rtol=0, atol=1e-5)
    np.testing.assert_allclose(f_t.scores[it], f_j.scores[ij], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(f_t.image_size, f_j.image_size)
    if with_labels:
        np.testing.assert_array_equal(f_t.labels[it], f_j.labels[ij])
        # Labelled-first after the cross-scale merge: no unlabelled
        # keypoint ranks above a labelled one.
        lab = f_t.labels > 0
        assert lab.any() and (~lab).any()
        assert not np.any(~lab[:-1] & lab[1:])
    else:
        assert f_t.labels is None


@pytest.mark.parametrize("min_edges", [[1200], [1200, 300, 255], [256, 307, 308], [2000, 640]])
def test_auto_scales_matches_jax(min_edges):
    assert textract.auto_scales(min_edges) == jextract.auto_scales(min_edges)


def test_presets_match_jax():
    assert set(textract.EXTRACTION_CONFS) == set(jextract.EXTRACTION_CONFS)
    for name, jc in jextract.EXTRACTION_CONFS.items():
        tc = textract.EXTRACTION_CONFS[name]
        for f in dataclasses.fields(tc):
            if f.name != "bf16":  # resolved per device in each package
                assert getattr(tc, f.name) == getattr(jc, f.name), (name, f.name)
    assert textract.EXTRACTION_CONFS["sfd2-n4096-r1600-ms"].scales == (1.0, 0.8333, 0.6944)


@pytest.mark.parametrize("scales", ["ms", "msauto"])
@pytest.mark.parametrize("labels", [False, True])
def test_multiscale_extraction_matches_jax(variables, scales, labels):
    preset = textract.EXTRACTION_CONFS[f"sfd2-n4096-r1600-{scales}"]
    jex, tex = _extractors(variables, scales=preset.scales)
    imgs = [_textured(np.random.default_rng(1), 180, 240),
            _textured(np.random.default_rng(2), 300, 200)]
    lmaps = [_label_map(*im.shape[:2]) for im in imgs] if labels else None
    for f_t, f_j in zip(tex.extract_batch(imgs, lmaps), jex.extract_batch(imgs, lmaps)):
        _same_features(f_t, f_j, labels)


def _nms_maps(seed, b=2, h=64, w=96, c=16):
    rng = np.random.default_rng(seed)
    heat = rng.random((b, h, w)).astype(np.float32) ** 4
    desc = rng.normal(size=(b, h // 4, w // 4, c)).astype(np.float32)
    stab = rng.choice(np.array([0.1, 0.5, 1.0], np.float32), size=(b, h, w))
    lab = np.where(rng.random((b, h, w)) < 0.5, rng.integers(1, 4, (b, h, w)), 0)
    lab[:, :, : w // 3] = 0
    return heat, desc, stab, lab.astype(np.int32)


@pytest.mark.parametrize("k", [16, 64, 400])
@pytest.mark.parametrize("with_sizes", [False, True])
def test_labelled_topk_matches_jax(k, with_sizes):
    heat, desc, stab, lab = _nms_maps(k)
    sizes = np.array([[96, 64], [70, 50]], np.int32) if with_sizes else None
    kw = dict(max_keypoints=k, conf_threshold=0.01, nms_radius=3, border=4)
    got = extract_keypoints(*(torch.from_numpy(a) if a is not None else None
                              for a in (heat, desc, stab, sizes, lab)), **kw)
    ref = jextract_keypoints(*(jnp.asarray(a) if a is not None else None
                               for a in (heat, desc, stab, sizes, lab)), **kw)
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    assert valid.sum() > 0 and got.labels.dtype == torch.int32
    for f in ("xy", "scores", "labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[valid],
                                      np.asarray(getattr(ref, f))[valid])
    np.testing.assert_allclose(got.descriptors.numpy()[valid],
                               np.asarray(ref.descriptors)[valid], rtol=0, atol=1e-5)
    # Labelled first: within each image no unlabelled row precedes a labelled one.
    lab_rows = (got.labels.numpy() > 0) & valid
    assert not np.any(~lab_rows[:, :-1] & lab_rows[:, 1:] & valid[:, :-1])


def _separated_heatmap(h, w, pts, scores):
    hm = np.zeros((h, w), np.float32)
    for (y, x), s in zip(pts, scores):
        hm[y, x] = s
    return hm


def test_labelled_first_topk():
    """tests/test_label_chain.py::test_labeled_first_topk on the port: low
    scored labelled peaks outrank high scored unlabelled ones."""
    h = w = 64
    labeled_pts, unlabeled_pts = [(10, 10), (10, 30), (10, 50)], [(40, 10), (40, 30), (40, 50)]
    hm = _separated_heatmap(h, w, labeled_pts + unlabeled_pts, [0.2, 0.3, 0.1, 0.9, 0.8, 0.7])
    labels = np.zeros((h, w), np.int32)
    labels[:20] = 7
    desc = np.random.default_rng(0).normal(size=(1, h // 4, w // 4, 16)).astype(np.float32)
    kp = extract_keypoints(torch.from_numpy(hm[None]), torch.from_numpy(desc),
                           label_map=torch.from_numpy(labels[None]), max_keypoints=4,
                           conf_threshold=0.01, nms_radius=4, border=2)
    xy, lab, sc = kp.xy[0].numpy(), kp.labels[0].numpy(), kp.scores[0].numpy()
    assert kp.valid.all()
    assert (lab[:3] == 7).all()
    np.testing.assert_allclose(sc[:3], [0.3, 0.2, 0.1], atol=1e-6)
    assert {tuple(p) for p in xy[:3].astype(int)} == {(10, 10), (30, 10), (50, 10)}
    assert lab[3] == 0
    np.testing.assert_allclose(sc[3], 0.9, atol=1e-6)
    plain = extract_keypoints(torch.from_numpy(hm[None]), torch.from_numpy(desc),
                              max_keypoints=2, conf_threshold=0.01)
    assert plain.labels is None
    np.testing.assert_allclose(plain.scores[0].numpy(), [0.9, 0.8], atol=1e-6)


def test_label_map_helpers_match_jax(tmp_path):
    m = np.zeros((8, 8, 3), np.uint8)
    m[0, 0] = (1, 2, 3)  # BGR → id = 3·65536 + 2·256 + 1
    m[3, 5] = (200, 0, 17)
    cv2.imwrite(str(tmp_path / "m.png"), m)
    ids = textract.load_label_map(tmp_path / "m.png")
    np.testing.assert_array_equal(ids, jextract.load_label_map(tmp_path / "m.png"))
    assert ids[0, 0] == 3 * 65536 + 2 * 256 + 1 and ids[1, 1] == 0
    lab = np.arange(35, dtype=np.int32).reshape(5, 7)
    for hw in ((8, 8), (5, 7), (3, 11), (13, 4)):
        np.testing.assert_array_equal(textract._resize_labels_nearest(lab, hw),
                                      jextract._resize_labels_nearest(lab, hw))


def _write_images_and_masks(tmp_path, rng, names_hw):
    (tmp_path / "imgs" / "db").mkdir(parents=True)
    (tmp_path / "masks" / "db").mkdir(parents=True)
    for name, (h, w), left_id in names_hw:
        cv2.imwrite(str(tmp_path / "imgs" / name), (_textured(rng, h, w) * 255).astype(np.uint8))
        m = np.zeros((h, w, 3), np.uint8)
        m[:, : w // 2, 0] = left_id  # blue channel = low byte of the packed id
        cv2.imwrite(str((tmp_path / "masks" / name).with_suffix(".png")), m)


def test_mask_ingestion_to_store_and_nnml(variables, tmp_path):
    """The label chain on the port, beside the JAX extract_to_store: the
    same image twice with masks that differ in the left half's id (5 vs 9);
    stores agree with JAX, NNM matches across the labels, NNML does not."""
    rng = np.random.default_rng(3)
    (tmp_path / "imgs" / "db").mkdir(parents=True)
    (tmp_path / "masks" / "db").mkdir(parents=True)
    img = (_textured(rng, 96, 128) * 255).astype(np.uint8)
    for n, left_id in (("db/a", 5), ("db/b", 9)):
        cv2.imwrite(str(tmp_path / "imgs" / f"{n}.jpg"), img)
        m = np.zeros((96, 128, 3), np.uint8)
        m[:, :64, 0] = left_id
        cv2.imwrite(str(tmp_path / "masks" / f"{n}.png"), m)
    names = ["db/a.jpg", "db/b.jpg"]
    jex, tex = _extractors(variables, batch_size=2)
    store = FeatureStore()
    assert tex.extract_to_store(tmp_path / "imgs", names, store, mask_dir=tmp_path / "masks") == 2
    with JFeatureStore(tmp_path / "j.h5", "w") as js:
        jex.extract_to_store(tmp_path / "imgs", names, js, mask_dir=tmp_path / "masks")
        for n in names:
            _same_features(store.read(n), js.read(n), True)
    fa, fb = store.read("db/a.jpg"), store.read("db/b.jpg")
    left = fa.keypoints[:, 0] < 64
    assert (fa.labels[left] == 5).all() and (fa.labels[~left] == 0).all()
    assert (fb.labels[fb.keypoints[:, 0] < 64] == 9).all()

    out = {}
    for matcher in ("NNM", "NNML"):
        ms = MatchStore()
        match_pairs(store, [tuple(names)], ms, MatchConfig(matcher=matcher, max_keypoints=K,
                                                           batch_size=1), device="cpu")
        out[matcher] = ms.read(*names)[0]
    m_nnm, m_nnml = out["NNM"][: len(left)], out["NNML"][: len(left)]
    assert (fb.labels[m_nnm[left][m_nnm[left] >= 0].astype(int)] == 9).any()
    assert (fb.labels[m_nnml[left][m_nnml[left] >= 0].astype(int)] != 9).all()
    assert (m_nnml[left] == -1).any() and (m_nnml[~left] >= 0).any()


def _reference_checkpoint(path, seed=0):
    """Seeded weights under the reference's key names, as the shipped
    checkpoint wraps them: {'model': {'module.<name>': tensor}, ...}."""
    gen = torch.Generator().manual_seed(seed)
    sd = TorchResSegNetV2().state_dict()
    wrapped = {}
    for k, v in sd.items():
        if v.is_floating_point():
            v = torch.randn(v.shape, generator=gen) * 0.05
            if k.endswith("running_var"):
                v = v.abs() + 0.5
        wrapped[f"module.{k}"] = v
    torch.save({"model": wrapped, "epoch": 7}, path)


def test_convert_checkpoint_matches_jax(tmp_path):
    path = tmp_path / "ref.pth"
    _reference_checkpoint(path)
    got = convert_checkpoint(path)
    ref = state_dict_from_flax(jconvert_checkpoint(str(path)))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)
    TorchResSegNetV2().load_state_dict(got)  # strict
    with pytest.raises(KeyError):
        from sfd2_torch.models.convert import convert_ressegnet

        convert_ressegnet({k: v for k, v in got.items() if k != "convDb.bias"})


def test_extract_features_cli_matches_jax(tmp_path):
    """Both CLIs on the same reference .pth, float32, at the -ms preset
    with masks. The JAX CLI at ``--bf16 off`` runs the unfused stem, which
    differs from the fused one by float32 rounding (~1e-6 before the
    trunk), so descriptors are held within 1e-4 here, as in
    ``tests/test_torch_extractor.py``; keypoint sets and labels exactly."""
    rng = np.random.default_rng(4)
    _write_images_and_masks(tmp_path, rng, [("db/a.jpg", (120, 160), 5),
                                            ("db/b.jpg", (150, 110), 9)])
    _reference_checkpoint(tmp_path / "ref.pth", seed=1)
    args = ["--image_dir", tmp_path / "imgs", "--weights", tmp_path / "ref.pth", "--conf",
            "sfd2-n4096-r1600-ms", "--mask_dir", tmp_path / "masks", "--bf16", "off"]
    args = [str(a) for a in args]
    assert t_cli.main(args + ["--export_fn", str(tmp_path / "t.h5"), "--device", "cpu"]) == 2
    j_cli.main(args + ["--export_fn", str(tmp_path / "j.h5")])
    with FeatureStore(tmp_path / "t.h5") as ts, JFeatureStore(tmp_path / "j.h5") as js:
        assert sorted(ts.keys()) == sorted(js.keys()) == ["db/a.jpg", "db/b.jpg"]
        for n in ts.keys():
            f_t, f_j = ts.read(n), js.read(n)
            assert set(np.unique(f_t.labels)) <= {0, 5, 9}
            key = lambda f: {tuple(p): i for i, p in enumerate(f.keypoints.tolist())}  # noqa
            kt, kj = key(f_t), key(f_j)
            assert set(kt) == set(kj) and len(kt) > 100
            it, ij = [kt[p] for p in sorted(kj)], [kj[p] for p in sorted(kj)]
            np.testing.assert_allclose(f_t.descriptors[it], f_j.descriptors[ij], atol=1e-4)
            np.testing.assert_array_equal(f_t.labels[it], f_j.labels[ij])


def test_extract_features_cli_refuses_what_is_not_ported(tmp_path, capsys):
    (tmp_path / "imgs").mkdir()
    base = ["--image_dir", str(tmp_path / "imgs"), "--export_fn", str(tmp_path / "f.h5"),
            "--device", "cpu"]
    for extractor in ("nope", "dir"):  # dir is a global extractor: cli/extract_global.py
        with pytest.raises(SystemExit):
            t_cli.main(base + ["--extractor", extractor])
        assert "invalid choice" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        t_cli.main(base + ["--extractor", "superpoint", "--mask_dir", str(tmp_path)])
    assert "only supported by the sfd2 extractor" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        t_cli.main(base + ["--weights", str(tmp_path / "w.ckpt")])
    assert ".ckpt" in capsys.readouterr().err


def test_seeded_weights_are_reproducible():
    a, b = t_cli.seeded_state_dict(3), t_cli.seeded_state_dict(3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["convDb.weight"], t_cli.seeded_state_dict(4)["convDb.weight"])


@pytest.mark.parametrize("r", [2, 4])
def test_nms_fast_host_matches_jax(r):
    rng = np.random.default_rng(r)
    pts = rng.uniform(0, 60, (300, 2))
    sc = rng.random(300)
    np.testing.assert_array_equal(nms_fast_host(pts, sc, 60, 60, r),
                                  jnms_fast_host(pts, sc, 60, 60, r))


def test_camera_depths_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(50, 3)) * 4
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    t = rng.normal(size=3)
    got = camera_depths(*(torch.from_numpy(a).float() for a in (pts, q, t)))
    ref = jcamera_depths(*(jnp.asarray(a, jnp.float32) for a in (pts, q, t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("exif", [False, True])
def test_camera_from_exif_matches_jax(tmp_path, exif):
    from PIL import Image as PILImage

    path = tmp_path / "x.jpg"
    im = PILImage.fromarray(np.zeros((30, 40, 3), np.uint8))
    if exif:
        ex = PILImage.Exif()
        ex.get_ifd(0x8769)[0xA405] = 28
        im.save(path, exif=ex)
    else:
        im.save(path)
    got, ref = camera_from_exif(path, 3), jcamera_from_exif(path, 3)
    assert (got.camera_id, got.model, got.width, got.height) == \
        (ref.camera_id, ref.model, ref.width, ref.height)
    np.testing.assert_array_equal(got.params, ref.params)
    assert got.params[0] == (28 / 35 * 40 if exif else 48.0)
