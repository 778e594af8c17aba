"""Training driver: epochs, LR decay, checkpoints, resume, logging.

Port of ``sfd2_tpu/training/trainer.py`` (``trainer.py``): Adam (lr 1e-4,
wd 5e-4, ``:29``), iteration-capped epochs (4000 × 40 in the shipped
config), exponential LR decay (``:166``), the NaN guard (``:151-163``),
the per-epoch checkpoint and the best-loss one (``:366-382``), an
append-only ``log.txt`` with the loss scalars every `log_every`
iterations (``:199-231``), ``metrics.jsonl``, TensorBoard scalars under
``tb/``, and resume (``:97-108``).

Checkpoints are ``torch.save`` payloads {model state_dict, optimizer
state_dict, epoch, step, extra}, written to a temporary file and renamed,
as ``last.ckpt`` and ``best.ckpt`` in the run directory (the JAX package
writes Flax msgpack). ``load_model_state`` reads the model entry, which
``cli/extract_features.py --weights`` takes. The sampler's positions of
step `it` of epoch `e` come from a ``torch.Generator`` on the device
seeded ``fold_seed(7, e·100000 + it)``, where the JAX trainer folds the
same integer into ``PRNGKey(7)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sfd2_torch.localization.ransac import fold_seed
from sfd2_torch.models.sfd2 import ResSegNetV2
from sfd2_torch.models.superpoint import SuperPoint
from sfd2_torch.training.train_step import (TrainBatch, TrainConfig, TrainState,
                                            init_train_state, lr_at_step, make_train_step)
from sfd2_torch.utils.device import resolve_device
from sfd2_torch.utils.tb_writer import ScalarEventWriter

STEP_KEY = 7  # the JAX trainer's PRNGKey(7)


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 40
    iters_per_epoch: int = 4000
    batch_size: int = 4
    log_every: int = 50
    save_dir: str = "runs/sfd2"
    run_name: Optional[str] = None
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def run_dir(self) -> Path:
        name = self.run_name or (f"sfd2_bs{self.batch_size}_lr{self.train.lr:g}"
                                 f"_it{self.iters_per_epoch}x{self.epochs}")
        return Path(self.save_dir) / name


def save_checkpoint(path: Path, state: TrainState, epoch: int, extra: dict | None = None):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "epoch": int(epoch), "step": int(state.step), "extra": dict(extra or {})}
    tmp = path.with_suffix(".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: Path, state: TrainState):
    """Restore `state` in place from a checkpoint; returns (state, epoch,
    extra)."""
    dev = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state, int(ckpt["epoch"]), dict(ckpt.get("extra", {}))


def load_model_state(path) -> dict:
    """The model state_dict of a trainer checkpoint, on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(ckpt, dict) and {"model", "optimizer", "epoch", "step"} <= set(ckpt)):
        raise ValueError(f"{path} is not a checkpoint of sfd2_torch's trainer")
    return ckpt["model"]


def batch_to_device(batch_np: dict, device) -> TrainBatch:
    """A loader batch (numpy, or tensors already on the device) →
    TrainBatch on `device`, without waiting for the device; no ``seg1``
    gives zeros (the seg losses are off then)."""
    def up(a, dtype=torch.float32):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device, dtype, non_blocking=True)

    seg1 = batch_np.get("seg1")
    if seg1 is None:
        seg1 = np.zeros(batch_np["mask"].shape, np.int32)
    return TrainBatch(
        image1=up(batch_np["image1"]), image2=up(batch_np["image2"]),
        gray1=up(batch_np["gray1"]), gray2=up(batch_np["gray2"]), aflow=up(batch_np["aflow"]),
        seg1=up(seg1, torch.int64),
        teacher_feats=tuple(up(f) for f in batch_np.get("teacher_feats", ())))


class Trainer:
    """The host loop around `make_train_step`. `timer`, when given, is
    called as ``timer(name)`` → context manager around the loader wait
    (``loader``), the host→device copy (``upload``), the step (``step``)
    and the step's own stages (``make_train_step``)."""

    def __init__(self, loader, config: TrainerConfig = TrainerConfig(),
                 model: Optional[ResSegNetV2] = None, superpoint: Optional[SuperPoint] = None,
                 seed: int = 0, device="cuda", timer=None):
        self.cfg = config
        self.loader = loader
        self.device = resolve_device(device)
        model = model or ResSegNetV2(require_stability=True, require_feature=True)
        self.state = init_train_state(model, config.train, seed, self.device)
        if superpoint is None:
            from sfd2_torch.pipeline.extractors import seeded_init_

            superpoint = seeded_init_(SuperPoint(), 1)
        self.superpoint = superpoint.to(self.device)
        # One step function per seg availability: a loader without semantic
        # labels turns the seg losses off rather than feeding zeros.
        self._step_fns = {}
        self.timer = timer
        self.run_dir = config.run_dir()
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.log_path = self.run_dir / "log.txt"
        self.metrics_path = self.run_dir / "metrics.jsonl"
        self.tb = ScalarEventWriter(self.run_dir / "tb")
        self.start_epoch = 0
        self.best_loss = float("inf")

    def _log(self, msg: str):
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        with open(self.log_path, "a") as f:
            f.write(f"[{stamp}] {msg}\n")

    def _metrics(self, record: dict):
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _time(self, name: str):
        return self.timer(name) if self.timer else contextlib.nullcontext()

    def resume(self, path=None) -> bool:
        path = Path(path) if path else self.run_dir / "last.ckpt"
        if not path.exists():
            return False
        self.state, epoch, extra = load_checkpoint(path, self.state)
        self.start_epoch = epoch + 1
        self.best_loss = extra.get("best_loss", float("inf"))
        self._log(f"resumed from {path} at epoch {epoch}")
        return True

    def _step_for(self, has_seg: bool):
        if has_seg not in self._step_fns:
            tc = self.cfg.train
            if not has_seg and tc.use_seg:
                self._log("no seg labels in batches: disabling seg losses")
                tc = dataclasses.replace(tc, use_seg=False)
            self._step_fns[has_seg] = make_train_step(self.state.model, self.superpoint, tc,
                                                      timer=self.timer)
        return self._step_fns[has_seg]

    def step_generator(self, epoch: int, it: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_seed(STEP_KEY, epoch * 100_000 + it))
        return gen

    def process_epoch(self, epoch: int) -> float:
        losses = []
        t0 = time.time()
        batches = iter(self.loader.epoch(epoch))
        it = 0
        while it < self.cfg.iters_per_epoch:
            with self._time("loader"):
                batch_np = next(batches, None)
            if batch_np is None:
                break
            with self._time("upload"):
                batch = batch_to_device(batch_np, self.device)
            with self._time("step"):
                self.state, metrics = self._step_for("seg1" in batch_np)(
                    self.state, batch, self.step_generator(epoch, it))
            if it % self.cfg.log_every == 0:
                vals = {k: float(v) for k, v in metrics.items()}
                losses.append(vals["loss"])
                self._log(f"epoch {epoch} it {it} "
                          + " ".join(f"{k}={v:.4f}" for k, v in vals.items()))
                self._metrics({"epoch": epoch, "it": it, **vals})
                step = epoch * self.cfg.iters_per_epoch + it
                for k, v in vals.items():
                    self.tb.add_scalar(f"train/{k}", v, step)
                self.tb.add_scalar("train/lr", lr_at_step(self.cfg.train, self.state.step), step)
            it += 1
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        self._log(f"epoch {epoch} done in {time.time()-t0:.1f}s mean_loss={mean_loss:.4f}")
        return mean_loss

    def train(self, resume: bool = False) -> TrainState:
        if resume:
            self.resume()
        for epoch in range(self.start_epoch, self.cfg.epochs):
            mean_loss = self.process_epoch(epoch)
            extra = {"best_loss": self.best_loss, "mean_loss": mean_loss}
            save_checkpoint(self.run_dir / "last.ckpt", self.state, epoch, extra)
            if np.isfinite(mean_loss) and mean_loss < self.best_loss:
                self.best_loss = mean_loss
                save_checkpoint(self.run_dir / "best.ckpt", self.state, epoch, extra)
        return self.state
