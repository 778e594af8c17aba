"""The port's ConvNeXt-UPerNet teacher against the JAX package's.

``ConvNeXtUPerNet(arch="tiny", head_channels=64, aux_channels=32)`` with
seeded weights and random BN statistics (numpy seed): the port's
state_dict carries mmseg's names, so the JAX package's own mmseg
converter (``convert_upernet``) reads it, and ``upernet_from_flax``
carries a Flax initialisation the other way. At 64² the logits (and the
auxiliary head's) agree within 1e-4 of their largest magnitude and the
labels on ≥ 99 % of pixels; ``Segmentor``'s slide mode on a 96×128 image
(crop 64, stride 43) and its whole mode agree the same way; ``SegTeacher``
labels a batch as the JAX one does.
"""

import jax
import numpy as np
import pytest
import torch

from sfd2_torch.models import upernet as t_up
from sfd2_torch.models.convnext import ConvNeXt as TConvNeXt
from sfd2_torch.models.convnext import convert_convnext, convnext_from_flax
from sfd2_torch.training import seg_teacher as t_teacher
from sfd2_tpu.models import convnext as j_cn
from sfd2_tpu.models import upernet as j_up
from sfd2_tpu.training import seg_teacher as j_teacher

torch.set_num_threads(2)

KW = dict(arch="tiny", head_channels=64, aux_channels=32)


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def _labels_agree(got, ref, at_least=0.99):
    agree = (np.asarray(got) == np.asarray(ref)).mean()
    assert agree >= at_least, agree


@pytest.fixture(scope="module")
def port_model():
    model = t_up.seeded_segmentor(seed=3, **KW)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(rng.normal(size=m.num_features) * 0.2))
                m.running_var.copy_(torch.from_numpy(rng.random(m.num_features) + 0.5))
                m.weight.copy_(torch.from_numpy(rng.random(m.num_features) + 0.5))
                m.bias.copy_(torch.from_numpy(rng.normal(size=m.num_features) * 0.1))
            elif isinstance(m, (torch.nn.LayerNorm, torch.nn.Conv2d, torch.nn.Linear)):
                if m.bias is not None:
                    m.bias.copy_(torch.from_numpy(rng.normal(size=m.bias.shape) * 0.05))
    return model.eval()


@pytest.fixture(scope="module")
def jax_vars(port_model):
    sd = {k: v.numpy() for k, v in port_model.state_dict().items()}
    return j_up.convert_upernet(sd, arch="tiny")  # mmseg names → Flax


def _image(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_upernet_matches_jax_through_the_mmseg_converter(port_model, jax_vars):
    x = _image((2, 64, 64, 3))
    jm = j_up.ConvNeXtUPerNet(**KW)
    ref, ref_aux = jax.jit(lambda v, x: jm.apply(v, x, with_aux=True))(jax_vars, x)
    with torch.no_grad():
        got, got_aux = port_model(torch.from_numpy(x), with_aux=True)
    assert got.shape == (2, 16, 16, 150)
    _close(got.numpy(), ref)
    _close(got_aux.numpy(), ref_aux)
    _labels_agree(got.numpy().argmax(-1), np.asarray(ref).argmax(-1))


def test_flax_initialisation_carries_across():
    jm = j_up.ConvNeXtUPerNet(**KW)
    x = _image((1, 64, 64, 3), seed=2)
    v = jax.jit(lambda k, x: jm.init(k, x, with_aux=True))(jax.random.PRNGKey(0), x)
    port = t_up.ConvNeXtUPerNet(**KW)
    port.load_state_dict(t_up.upernet_from_flax(v, arch="tiny"))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    _close(got.numpy(), jax.jit(jm.apply)(v, x))
    # The backbone alone, through convnext_from_flax.
    bb = j_cn.ConvNeXt(arch="tiny", out_indices=(0, 1))
    bv = jax.jit(bb.init)(jax.random.PRNGKey(1), x)
    tb = TConvNeXt("tiny", out_indices=(0, 1))
    tb.load_state_dict(convnext_from_flax(bv["params"], "tiny"))
    with torch.no_grad():
        feats = tb(torch.from_numpy(x))
    for f, r in zip(feats, jax.jit(bb.apply)(bv, x)):
        _close(f.numpy(), r)


@pytest.mark.parametrize("mode", ["slide", "whole"])
def test_segmentor_matches_jax(port_model, jax_vars, mode):
    img = (np.random.default_rng(4).random((96, 128, 3)) * 255).astype(np.uint8)
    cfg = dict(crop=64, stride=43, mode=mode)
    ref = j_up.Segmentor(jax_vars, j_up.SegmentorConfig(**cfg), model=j_up.ConvNeXtUPerNet(**KW))
    got = t_up.Segmentor(port_model, t_up.SegmentorConfig(**cfg), device="cpu")
    fn = "logits_slide" if mode == "slide" else "logits_whole"
    _close(getattr(got, fn)(img), getattr(ref, fn)(img))
    _labels_agree(got.evaluate(img), ref.evaluate(img))


def test_seg_teacher_labels_match_jax(port_model, jax_vars):
    raw = np.random.default_rng(5).random((2, 64, 64, 3)).astype(np.float32)
    ref = j_teacher.SegTeacher(jax_vars, model=j_up.ConvNeXtUPerNet(**KW)).label_batch(raw)
    teacher = t_teacher.SegTeacher(port_model, device="cpu")
    got = teacher.label_batch(raw)
    assert got.dtype == np.int32 and got.min() >= 1 and got.max() <= 150
    _labels_agree(got, ref)

    class Loader:
        def epoch(self, e):
            yield {"raw1": raw, "mask": np.ones((2, 64, 64), bool)}

    batch = next(t_teacher.SegTeacherLoader(Loader(), teacher).epoch(0))
    np.testing.assert_array_equal(batch["seg1"].numpy(), got)


def test_mmseg_checkpoint_loads_by_name(port_model, tmp_path):
    sd = {f"module.{k}": v for k, v in port_model.state_dict().items()
          if not k.startswith("auxiliary_head.")}  # exported without the aux head
    torch.save({"state_dict": sd, "meta": {}}, tmp_path / "seg.pth")
    state = torch.load(tmp_path / "seg.pth", weights_only=True)
    model = t_up.load_mmseg_state_dict(t_up.ConvNeXtUPerNet(**KW), state)
    for k, v in port_model.state_dict().items():
        if not k.startswith("auxiliary_head."):
            assert torch.equal(model.state_dict()[k], v), k
    del sd["module.decode_head.conv_seg.weight"]
    with pytest.raises(KeyError, match="conv_seg"):
        t_up.load_mmseg_state_dict(t_up.ConvNeXtUPerNet(**KW), {"state_dict": sd})


def test_entry_points_ask_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_teacher.SegTeacher(t_up.ConvNeXtUPerNet(**KW))


def test_label_dir_teacher_matches_jax(tmp_path):
    import cv2

    rng = np.random.default_rng(6)
    (tmp_path / "db").mkdir()
    lab = rng.integers(0, 150, size=(30, 40)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "db" / "a.png"), lab)  # mirrored relative path
    cv2.imwrite(str(tmp_path / "b.png"), lab[:20, :30])  # flat layout, other size
    got, ref = t_teacher.LabelDirTeacher(tmp_path), j_teacher.LabelDirTeacher(tmp_path)
    for name, hw in (("db/a.jpg", (30, 40)), ("q/b.jpg", (30, 40)), ("db/none.jpg", (5, 6))):
        g, r = got.label_image(name, hw), ref.label_image(name, hw)
        assert g.dtype == np.int32 and g.shape == hw
        np.testing.assert_array_equal(g, r)


def test_mmcls_convnext_checkpoint_matches_jax_converter():
    """A ConvNeXt state_dict under mmseg's ``backbone.`` prefix: the JAX
    package's ``convert_convnext`` and the port's read the same weights."""
    tb = TConvNeXt("tiny", out_indices=(0, 1))
    state = {f"backbone.{k}": v.numpy() for k, v in tb.state_dict().items()}
    x = _image((1, 64, 64, 3), seed=7)
    ref = jax.jit(j_cn.ConvNeXt(arch="tiny", out_indices=(0, 1)).apply)(
        j_cn.convert_convnext(state, arch="tiny"), x)
    port = TConvNeXt("tiny", out_indices=(0, 1))
    port.load_state_dict(convert_convnext(state))
    with torch.no_grad():
        for f, r in zip(port(torch.from_numpy(x)), ref):
            _close(f.numpy(), r)


def test_convert_upernet_matches_jax_converter(port_model):
    """Both packages' ``convert_upernet`` read the same mmseg checkpoint to
    the same weights: the JAX variables carried back by ``upernet_from_flax``
    equal the port's converted state_dict, which loads into the model."""
    sd = {f"module.{k}": v.numpy() for k, v in port_model.state_dict().items()}
    got = t_up.convert_upernet({"state_dict": sd}, arch="tiny")
    ref = t_up.upernet_from_flax(j_up.convert_upernet(sd, arch="tiny"), arch="tiny")
    assert set(got) == set(port_model.state_dict())
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            assert got[k].dtype == torch.float32, k
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    model = t_up.ConvNeXtUPerNet(**KW)
    model.load_state_dict(got)
    # Without the auxiliary head (as some mmseg exports) the rest converts.
    bare = {k: v for k, v in sd.items() if ".auxiliary_head." not in k}
    assert not any(k.startswith("auxiliary_head.")
                   for k in t_up.convert_upernet(bare, arch="tiny"))
    del bare["module.decode_head.bottleneck.conv.weight"]
    with pytest.raises(KeyError, match="bottleneck"):
        t_up.convert_upernet(bare, arch="tiny")


@pytest.mark.parametrize("h,w,out", [(7, 9, 3), (2, 2, 6), (32, 32, 1), (10, 6, 6),
                                     (16, 16, 2)])
def test_adaptive_avg_pool_matches_jax(h, w, out):
    x = np.random.default_rng(h * w + out).normal(size=(2, h, w, 5)).astype(np.float32)
    got = t_up.adaptive_avg_pool(torch.from_numpy(x), out)
    ref = np.asarray(j_up.adaptive_avg_pool(x, out))
    assert got.shape == ref.shape == (2, out, out, 5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
