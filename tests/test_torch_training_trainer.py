"""The port's trainer: resume is exact, the files are the JAX trainer's.

On the CPU, two epochs straight and one epoch, a resume from
``last.ckpt`` and one more epoch give bit-identical parameters, Adam
state, BatchNorm statistics and logged losses (full-width ResSegNetV2 at
48², two iterations per epoch over an in-memory dataset). The TensorBoard
event records equal the JAX writer's bytes for the same scalars, wall
time aside. Without ``seg1`` in the batches the seg losses are off.
"""

import json
import time

import numpy as np
import pytest
import torch

from sfd2_torch.training import trainer as t_trainer
from sfd2_torch.training.data import ArrayDataset, PairLoader, SyntheticPairBuilder
from sfd2_torch.training.losses import SegLossConfig
from sfd2_torch.training.sampler import NghSampler2DS
from sfd2_torch.training.train_step import TrainConfig
from sfd2_torch.utils import tb_writer as t_tb
from sfd2_tpu.utils import tb_writer as j_tb
from test_torch_training_data import texture
from test_torch_training_losses import TINY_SAMPLER

torch.set_num_threads(2)


def _images(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [texture(rng, 60, 64) for _ in range(n)]


class _SegLoader:
    """PairLoader batches with fixed labels, as a teacher would add."""

    def __init__(self, loader):
        self.loader = loader

    def epoch(self, e):
        for b in self.loader.epoch(e):
            b = dict(b)
            b["seg1"] = (np.arange(b["mask"].size).reshape(b["mask"].shape) % 150 + 1)
            yield b


def _trainer(tmp_path, epochs, with_seg=True, name="run"):
    loader = PairLoader(ArrayDataset(_images()), SyntheticPairBuilder(crop=48), batch_size=1,
                        seed=3, workers=2, iters_per_epoch=2)
    cfg = t_trainer.TrainerConfig(
        epochs=epochs, iters_per_epoch=2, batch_size=1, log_every=1, save_dir=str(tmp_path),
        run_name=name, train=TrainConfig(loss=SegLossConfig(topk_per_half=32),
                                         sampler=NghSampler2DS(**TINY_SAMPLER)))
    return t_trainer.Trainer(_SegLoader(loader) if with_seg else loader, cfg, seed=0,
                             device="cpu")


def _metrics(path):
    return [json.loads(l) for l in (path / "metrics.jsonl").read_text().splitlines()]


def test_resume_is_bit_exact(tmp_path):
    straight = _trainer(tmp_path, 2, name="straight")
    straight.train()
    first = _trainer(tmp_path, 1, name="resumed")
    first.train()
    second = _trainer(tmp_path, 2, name="resumed")
    assert second.resume() and second.start_epoch == 1
    second.train()
    a, b = straight.state, second.state
    assert a.step == b.step == 4
    for (k, u), v in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(u, v), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), key
    ma, mb = _metrics(tmp_path / "straight"), _metrics(tmp_path / "resumed")
    assert ma == mb and len(ma) == 4
    for rec in ma:
        assert all(np.isfinite(v) for k, v in rec.items() if k not in ("epoch", "it"))
        assert {"det_loss", "unsup_desc_loss", "seg_det_loss", "seg_desc_loss"} <= set(rec)
    run = tmp_path / "resumed"
    for f in ("last.ckpt", "best.ckpt", "log.txt", "metrics.jsonl"):
        assert (run / f).is_file(), f
    assert list((run / "tb").glob("events.out.tfevents.*"))
    assert "resumed from" in (run / "log.txt").read_text()
    ckpt = torch.load(run / "last.ckpt", weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 4 and set(ckpt["extra"]) == {"best_loss",
                                                                              "mean_loss"}
    sd = t_trainer.load_model_state(run / "last.ckpt")
    assert int(sd["conv1a.1.num_batches_tracked"]) == 4


def test_batches_without_labels_turn_the_seg_losses_off(tmp_path):
    tr = _trainer(tmp_path, 1, with_seg=False)
    tr.train()
    rec = _metrics(tmp_path / "run")[0]
    assert "seg_det_loss" not in rec and "seg_desc_loss" not in rec
    assert "disabling seg losses" in (tmp_path / "run" / "log.txt").read_text()


def test_tb_records_equal_the_jax_writer(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234567.25)
    scalars = [("train/loss", 0.5, 0), ("train/lr", 1e-4, 50), ("train/det_loss", 2.0, 1 << 40)]
    for mod, d in ((t_tb, "t"), (j_tb, "j")):
        with mod.ScalarEventWriter(tmp_path / d) as w:
            for tag, v, step in scalars:
                w.add_scalar(tag, v, step)
    got = next((tmp_path / "t").iterdir())
    ref = next((tmp_path / "j").iterdir())
    assert got.read_bytes() == ref.read_bytes()
    assert t_tb._crc32c(b"123456789") == 0xE3069283


def test_trainer_asks_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = t_trainer.TrainerConfig(save_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_trainer.Trainer(None, cfg)


def test_config_helpers_match_jax(tmp_path):
    import argparse
    import dataclasses

    import jax
    import jax.numpy as jnp

    from sfd2_torch.models.sfd2 import ResSegNetV2 as TResSegNetV2
    from sfd2_torch.utils import config as t_cfg
    from sfd2_tpu.models.sfd2 import ResSegNetV2
    from sfd2_tpu.utils import config as j_cfg

    (tmp_path / "c.json").write_text(json.dumps({"lr": 0.5, "save_dir": "x"}))
    for mod in (t_cfg, j_cfg):
        args = mod.apply_json_overlay(argparse.Namespace(lr=1.0, bs=4, root=tmp_path),
                                      tmp_path / "c.json")
        mod.save_args(args, tmp_path / f"{mod.__name__}.json")
    assert (t_cfg.load_args(tmp_path / f"{t_cfg.__name__}.json")
            == j_cfg.load_args(tmp_path / f"{j_cfg.__name__}.json"))

    @dataclasses.dataclass
    class Inner:
        a: int = 1

    @dataclasses.dataclass
    class Outer:
        inner: Inner = dataclasses.field(default_factory=Inner)
        b: float = 2.0

    data = {"inner": {"a": 5}, "b": 3.0, "unknown": 1}
    assert t_cfg.dataclass_from_dict(Outer, data) == j_cfg.dataclass_from_dict(Outer, data)
    model = ResSegNetV2(require_stability=True, require_feature=True)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    assert t_cfg.model_size(TResSegNetV2()) == j_cfg.model_size(params["params"])
