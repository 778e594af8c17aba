"""One training step: student + SuperPoint teacher + SegLoss + Adam.

Port of ``sfd2_tpu/training/train_step.py`` (``trainer.py:258``
forward_backward): the student's training forward (BatchNorm on batch
statistics) on the concatenated pair batch, the frozen SuperPoint's
targets with the ≥score_th det-weight map (``:321-343``), img1's semantic
map carried into img2 through the flow (``:293-305``), seg → confidence,
SegLoss, and Adam (lr 1e-4, weight decay 5e-4, ``trainer.py:29``).

The optimiser is optax's ``chain(add_decayed_weights, scale_by_adam,
scale_by_learning_rate)`` of the JAX package: the decay is added to the
gradient before Adam's moments (coupled L2, ``torch.optim.Adam``'s
``weight_decay``, not AdamW), eps 1e-8, and the rate
``min(lr·rate^(count−decay_iter), lr)`` on Adam's own count of updates.

The NaN guard (``trainer.py:151-163``) stays on the device: a step whose
loss or gradient is not finite leaves the parameters, Adam's moments and
step counts and BatchNorm's running statistics as they were (BatchNorm
moves them during the forward, so they are put back). On CUDA the
optimiser is ``capturable`` (its step counts live on the device), and the
guard costs no host synchronisation.

Data-parallel (``group``, one process per device,
``parallel/distributed.py``): each rank runs the student and SuperPoint on
its slice of the batch, with BatchNorm synchronised over the group
(``convert_sync_batchnorm``); the outputs and the batch are gathered, so
every rank evaluates the loss of the global batch, sampler positions
included; the gradients are summed over the ranks and every rank takes
the same guarded Adam step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, NamedTuple

import torch
import torch.distributed as dist

from sfd2_torch.models.sfd2 import ResSegNetV2
from sfd2_torch.models.superpoint import SuperPoint
from sfd2_torch.training.losses import SegLossConfig, SegLossInputs, seg_loss
from sfd2_torch.training.sampler import NghSampler2DS
from sfd2_torch.training.semantics import semantic_to_confidence

ADAM_BETAS = (0.9, 0.999)  # optax.scale_by_adam's defaults
ADAM_EPS = 1e-8


class TrainBatch(NamedTuple):
    """One pair batch (already ImageNet-normalised / grayscale), NHWC."""

    image1: torch.Tensor  # [B, H, W, 3]
    image2: torch.Tensor  # [B, H, W, 3]
    gray1: torch.Tensor  # [B, H, W, 1]
    gray2: torch.Tensor  # [B, H, W, 1]
    aflow: torch.Tensor  # [B, H, W, 2] absolute flow img1→img2 (NaN invalid)
    seg1: torch.Tensor  # [B, H, W] int ADE20k labels of img1
    # Optional ConvNeXt teacher features of the [2B, …] pair batch (stages
    # 0-1); an empty tuple turns the seg_feat loss off.
    teacher_feats: tuple = ()


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 5e-4
    score_th: float = 0.001
    det_weight: float = 1.0  # reference --det_weight default (train.py:167)
    decay_rate: float = 1.0  # exponential LR decay (trainer.py:166)
    decay_iter: int = 0
    use_seg: bool = True  # False without semantic labels: seg_det and
    #                       seg_desc off rather than trained on zeros
    loss: SegLossConfig = SegLossConfig()
    sampler: NghSampler2DS = NghSampler2DS()


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the optimiser
    (Adam's moments and counts) and the count of steps taken, skipped
    ones included (the JAX ``TrainState.step``)."""

    model: ResSegNetV2
    optimizer: torch.optim.Adam
    step: int = 0


def warp_seg_forward(seg1: torch.Tensor, aflow: torch.Tensor):
    """Carry img1's label map through the flow into img2's frame
    (``trainer.py:293-305``): each img1 pixel writes its label at its
    rounded flow target. Where several img1 pixels land on one img2 pixel
    the one with the largest flat index wins (``scatter_reduce`` 'amax',
    deterministic on every device); the JAX scatter names no winner.
    Returns (seg2, valid_mask2)."""
    b, h, w = seg1.shape
    tx = torch.floor(aflow[..., 0] + 0.5)
    ty = torch.floor(aflow[..., 1] + 0.5)
    ok = (torch.isfinite(tx) & torch.isfinite(ty) & (tx >= 0) & (ty >= 0)
          & (tx < w) & (ty < h))
    n = b * h * w
    bidx = torch.arange(b, device=seg1.device)[:, None, None]
    dest = bidx * (h * w) + torch.where(ok, ty, 0).long() * w + torch.where(ok, tx, 0).long()
    dest = torch.where(ok, dest, n)  # invalid targets write to a spare slot
    winner = torch.full((n + 1,), -1, dtype=torch.long, device=seg1.device)
    winner = winner.scatter_reduce(0, dest.reshape(-1),
                                   torch.arange(n, device=seg1.device), reduce="amax")[:n]
    mask2 = winner >= 0
    seg2 = torch.where(mask2, seg1.reshape(-1)[winner.clamp(min=0)], 0)
    return seg2.reshape(b, h, w).to(seg1.dtype), mask2.reshape(b, h, w)


def lr_at_step(cfg: TrainConfig, step: int) -> float:
    """The schedule min(lr·rate^(step−decay_iter), lr) on the host."""
    if cfg.decay_rate >= 1.0 or cfg.decay_iter <= 0:
        return float(cfg.lr)
    return float(min(cfg.lr * cfg.decay_rate ** max(step - cfg.decay_iter, 0), cfg.lr))


def make_optimizer(cfg: TrainConfig, model: torch.nn.Module) -> torch.optim.Adam:
    """Adam with coupled weight decay and its state made up front (step 0,
    zero moments), as ``optax``'s ``init``: the NaN guard and the JAX
    state converter find every entry. ``capturable`` on CUDA."""
    params = list(model.parameters())
    capturable = params[0].is_cuda
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                           weight_decay=cfg.weight_decay, capturable=capturable)
    for p in params:
        opt.state[p] = {
            "step": (torch.zeros((), dtype=torch.float32, device=p.device) if capturable
                     else torch.tensor(0.0, dtype=torch.float32)),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
        }
    return opt


def set_lr(cfg: TrainConfig, opt: torch.optim.Adam):
    """The schedule at Adam's count of updates (optax's count): on the
    device for a capturable optimiser, from the host count otherwise."""
    if cfg.decay_rate >= 1.0 or cfg.decay_iter <= 0:
        return
    count = next(iter(opt.state.values()))["step"]
    if count.is_cuda:
        lr = torch.clamp(cfg.lr * cfg.decay_rate ** torch.clamp(count - cfg.decay_iter, min=0),
                         max=cfg.lr)
    else:
        lr = lr_at_step(cfg, int(count))
    for group in opt.param_groups:
        group["lr"] = lr


def guarded_state(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a skipped step must leave as it was: parameters, Adam's
    moments and counts, BatchNorm's running statistics and counters."""
    out = [p.data for p in state.model.parameters()]
    for st in state.optimizer.state.values():
        out += [st["step"], st["exp_avg"], st["exp_avg_sq"]]
    return out + list(state.model.buffers())


def _gather_global(out, gt_score, gt_semi, batch: TrainBatch, group):
    """Each rank's [2b, …] outputs (image 1 then image 2) and [b, …] batch
    → the global batch's, laid out as one process would hold it."""
    from sfd2_torch.parallel.distributed import all_gather_cat

    def pairs(t):  # [2b, …] → [2B, …]: every rank's image-1 half first
        b = t.shape[0] // 2
        return torch.cat([all_gather_cat(t[:b], group), all_gather_cat(t[b:], group)])

    out = out._replace(**{f: pairs(getattr(out, f)) for f in
                          ("score", "descriptors", "semi", "stability_logits")
                          if getattr(out, f) is not None},
                       features=tuple(pairs(f) for f in out.features))
    batch = batch._replace(seg1=all_gather_cat(batch.seg1, group),
                           aflow=all_gather_cat(batch.aflow, group),
                           teacher_feats=tuple(pairs(f) for f in batch.teacher_feats))
    return out, pairs(gt_score), pairs(gt_semi), batch


def make_train_step(model: ResSegNetV2, superpoint: SuperPoint,
                    cfg: TrainConfig = TrainConfig(), timer=None, group=None):
    """Build `train_step(state, batch, gen, positions=None) → (state,
    metrics)`: `state.model` is `model`; `gen` (a ``torch.Generator`` on the
    batch's device) draws the sampler's positions unless `positions` gives
    them; `metrics` are 0-dim tensors on the device. `timer`, when given,
    is called as ``timer(name)`` → context manager around the stages
    ``forward`` (student, teacher, loss), ``backward`` and ``optimizer``
    (the guard and Adam). `group`: a process group to train data-parallel
    over (the module docstring); `model`'s BatchNorms must then be
    ``SyncBatchNorm2d`` over it, every rank passes its slice of the batch
    and a generator seeded alike, and the metrics are the global batch's."""
    stage = timer or (lambda name: contextlib.nullcontext())
    superpoint.eval().requires_grad_(False)
    loss_cfg = cfg.loss
    if not cfg.use_seg:
        loss_cfg = dataclasses.replace(loss_cfg, seg_det=False, seg_desc=False)

    def loss_fn(batch: TrainBatch, gen, positions):
        x = torch.cat([batch.image1, batch.image2], 0)
        out = model(x, training_outputs=True)
        with torch.no_grad():
            spp = superpoint(torch.cat([batch.gray1, batch.gray2], 0))
        gt_score, gt_semi = spp["scores"], spp["semi_norm"]
        if group is not None:
            out, gt_score, gt_semi, batch = _gather_global(out, gt_score, gt_semi, batch, group)
        weight = torch.where(gt_score >= cfg.score_th, cfg.det_weight, 1.0)

        seg2, mask2 = warp_seg_forward(batch.seg1, batch.aflow)
        seg = torch.cat([batch.seg1, seg2], 0)
        inputs = SegLossInputs(
            semi=out.semi, gt_semi=gt_semi, score=out.score, gt_score=gt_score,
            desc=out.descriptors, aflow=batch.aflow, weight=weight,
            seg_confidence=semantic_to_confidence(seg),
            seg_mask=torch.cat([torch.ones_like(mask2), mask2], 0), seg=seg,
            stability=out.stability_logits, pred_feats=out.features,
            gt_feats=tuple(f.detach() for f in batch.teacher_feats))
        lc = loss_cfg if inputs.gt_feats else dataclasses.replace(loss_cfg, seg_feat=False)
        return seg_loss(gen, inputs, cfg.sampler, lc, positions=positions)

    def train_step(state: TrainState, batch: TrainBatch, gen=None, positions=None):
        model.train()
        opt = state.optimizer
        with stage("forward"):
            kept = [t.clone() for t in guarded_state(state)]
            opt.zero_grad(set_to_none=False)
            metrics = loss_fn(batch, gen, positions)
        with stage("backward"):
            if group is None:
                metrics["loss"].backward()
            else:  # each rank backpropagates its share of the one global loss
                (metrics["loss"] / dist.get_world_size(group)).backward()
        with stage("optimizer"):
            for p in model.parameters():
                if p.grad is None:  # unused by this loss (ConvSta without seg_det):
                    p.grad = torch.zeros_like(p)  # Adam still decays it, as optax does
            if group is not None:
                from sfd2_torch.parallel.distributed import all_reduce_grads

                all_reduce_grads(model.parameters(), group)
            grads = [p.grad for p in model.parameters()]
            bad = torch.zeros(1, device=grads[0].device)
            # One fused pass over every gradient (the AMP scaler's check; the
            # scale 1 leaves them as they are).
            torch._amp_foreach_non_finite_check_and_unscale_(grads, bad, torch.ones_like(bad))
            finite = torch.isfinite(metrics["loss"].detach()) & (bad[0] == 0)
            set_lr(cfg, opt)
            opt.step()
            with torch.no_grad():
                for t, old in zip(guarded_state(state), kept):
                    t.copy_(torch.where(finite, t, old))
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def init_train_state(model: ResSegNetV2, cfg: TrainConfig, seed: int = 0,
                     device="cuda") -> TrainState:
    """`model` with seeded weights at the JAX init scale
    (``pipeline/extractors.py::seeded_init_``) on `device`, and its
    optimiser."""
    from sfd2_torch.pipeline.extractors import seeded_init_
    from sfd2_torch.utils.device import resolve_device

    model = seeded_init_(model, seed).to(resolve_device(device))
    return TrainState(model=model, optimizer=make_optimizer(cfg, model))
