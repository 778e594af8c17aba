"""``cli/train.py`` beside the JAX training CLI, and a trained checkpoint
through ``cli/extract_features.py --weights``.

Both CLIs run one epoch of two iterations over a temporary image folder
with the online teacher (``--segmentor_random``; the teacher cut to a
one-block-per-stage ConvNeXt UPerNet in both, for compile time): both log finite losses, every
term of the shipped configuration, and write the same files. The port
refuses an unknown ``--data_sources`` letter and a run without a source,
and asks for CUDA by default (``tests/test_torch_datasets_aachen.py``
trains from ``--data_sources`` and ``--flow_pair_list``). ``extract_features --weights last.ckpt`` gives
exactly what ``Extractor`` gives on the checkpoint's model entry.
"""

import dataclasses
import json

import cv2
import jax
import numpy as np
import pytest
import torch

from sfd2_torch.cli import extract_features as t_extract_cli
from sfd2_torch.cli import train as t_cli
from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.models import upernet as t_up
from sfd2_torch.pipeline.extract import EXTRACTION_CONFS, Extractor
from sfd2_torch.training import seg_teacher as t_teacher
from sfd2_torch.training.trainer import load_model_state
from sfd2_tpu.cli import train as j_cli
from sfd2_torch.models import convnext as t_cn
from sfd2_tpu.models import convnext as j_cn
from sfd2_tpu.models import upernet as j_up
from sfd2_tpu.training import seg_teacher as j_teacher
from sfd2_tpu.training import trainer as j_trainer
from test_torch_training_data import texture

torch.set_num_threads(2)

MICRO = {"depths": (1, 1, 1, 1), "channels": (16, 32, 64, 128)}
TINY = dict(arch="micro", head_channels=32, aux_channels=16)
FILES = {"args.json", "best.ckpt", "last.ckpt", "log.txt", "metrics.jsonl", "tb"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    (root / "imgs" / "sub").mkdir(parents=True)
    for i in range(3):
        img = (texture(rng, 90, 100) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "imgs" / ("sub" if i else "") / f"im{i}.png"), img)
    args = ["--image_dirs", str(root / "imgs"), "--epochs", "1", "--iters_per_epoch", "2",
            "--bs", "1", "--R", "72", "--workers", "1", "--segmentor_random",
            "--save_dir", str(root / "runs")]
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(j_cn.ARCH_SETTINGS, "micro", MICRO)
        mp.setitem(t_cn.ARCH_SETTINGS, "micro", MICRO)
        # The JAX trainer's eager init compiles op by op (≈ 30 s on the CPU);
        # the same function jitted gives the same state.
        j_init = j_trainer.init_train_state
        mp.setattr(j_trainer, "init_train_state", lambda model, cfg, key: jax.jit(
            lambda k: j_init(model, cfg, k))(key))
        jax_teacher = j_teacher.SegTeacher
        mp.setattr(j_teacher, "SegTeacher",
                   lambda: jax_teacher(model=j_up.ConvNeXtUPerNet(**TINY)))
        j_cli.main(args + ["--run_name", "jax"])
        port_teacher = t_teacher.SegTeacher
        mp.setattr(t_teacher, "SegTeacher", lambda device: port_teacher(
            t_up.seeded_segmentor(**TINY), device=device))
        t_cli.main(args + ["--run_name", "port", "--device", "cpu"])
    finally:
        mp.undo()
    return root


def test_both_clis_train_and_write_the_same_files(runs):
    for name in ("jax", "port"):
        run = runs / "runs" / name
        assert {p.name for p in run.iterdir()} == FILES, name
        recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
        assert len(recs) == 1  # log_every 50: iteration 0
        assert {"det_loss", "unsup_desc_loss", "seg_det_loss", "seg_desc_loss", "loss"} <= set(recs[0])
        assert all(np.isfinite(v) for v in recs[0].values())
    a = json.loads((runs / "runs" / "port" / "args.json").read_text())
    b = json.loads((runs / "runs" / "jax" / "args.json").read_text())
    assert set(a) - set(b) == {"device"} and a["R"] == b["R"] == 72


def test_trained_checkpoint_extracts_like_the_extractor(runs, tmp_path):
    ckpt = runs / "runs" / "port" / "last.ckpt"
    names = ["im0.png", "sub/im1.png", "sub/im2.png"]
    t_extract_cli.main(["--image_dir", str(runs / "imgs"), "--export_fn", str(tmp_path / "f.h5"),
                        "--conf", "sfd2-n4096-r1024", "--weights", str(ckpt), "--bf16", "off",
                        "--device", "cpu"])
    cfg = dataclasses.replace(EXTRACTION_CONFS["sfd2-n4096-r1024"], bf16=False)
    ex = Extractor(load_model_state(ckpt), cfg, device="cpu")
    ref = FeatureStore()
    ex.extract_to_store(runs / "imgs", names, ref)
    with FeatureStore(tmp_path / "f.h5") as got:
        assert sorted(got.keys()) == sorted(names)
        for n in names:
            g, r = got.read(n), ref.read(n)
            np.testing.assert_array_equal(g.keypoints, r.keypoints)
            np.testing.assert_array_equal(g.descriptors, r.descriptors)
            assert len(g.keypoints) > 20


def test_cli_refuses_what_is_not_ported(tmp_path, capsys):
    base = ["--save_dir", str(tmp_path / "runs"), "--device", "cpu"]
    with pytest.raises(ValueError, match="unknown data-source code 'X'"):
        t_cli.main(base + ["--data_sources", "X"])
    with pytest.raises(SystemExit):
        t_cli.main(base)
    assert "--data_sources, --flow_pair_list or --image_dirs" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_cli.main(["--image_dirs", str(tmp_path)])
