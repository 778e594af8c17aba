"""Data-parallel training: one process per device under ``torch.distributed``.

The JAX package trains data-parallel by running one global-batch program
over a mesh (``sfd2_tpu/parallel/mesh.py``): XLA reduces BatchNorm's
statistics and the gradients over the global batch. The torch idiom is a
process per device, each holding a slice of the batch, with explicit
collectives (``nccl`` on the card, ``gloo`` on the CPU). To give the global
batch's numbers:

* `SyncBatchNorm2d` normalises by the moments of the global batch (two
  all-reduces: the sums and counts, then the squared deviations) and
  moves the running variance by the *biased* global variance, as
  ``models/layers.py::BatchNorm2d`` does (``torch.nn.SyncBatchNorm`` uses
  n/(n−1) times it);
* `all_gather_cat` gathers the networks' outputs, so every rank evaluates
  the loss on the whole global batch: the AP loss's negatives and the
  seg-descriptor pairs span every image, and every masked mean divides by
  the global count;
* `all_reduce_grads` sums the gradients; every rank then takes the same
  Adam step.

The collectives' backward passes all-reduce the incoming gradients: each
rank backpropagates its share of one total (the loss divided by the world
size), and a slice's gradient sums what every rank sends it.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch
import torch.distributed as dist

from sfd2_torch.models.layers import BatchNorm2d


def init_process_group(rank: int, world_size: int, init_file, device="cuda"):
    """Join the group over a rendezvous file (``file://``, no port opened):
    ``nccl`` for a CUDA `device`, ``gloo`` otherwise. Every rank passes the
    same `init_file`, which must not exist before the first rank starts."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=Path(os.path.abspath(init_file)).as_uri(),
                            rank=rank, world_size=world_size)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        world, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(world)[rank], None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over ranks, differentiable."""
    return _AllReduceSum.apply(x, group)


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `x` concatenated on dim 0 in rank order,
    differentiable. All ranks' `x` have one shape."""
    return _AllGather.apply(x, group)


def all_reduce_grads(params, group=None):
    """Sum every parameter's gradient over the ranks, in one collective."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


class SyncBatchNorm2d(BatchNorm2d):
    """``BatchNorm2d`` over the global batch of a process group (see the
    module docstring); eval mode is ``BatchNorm2d``'s. Made from a
    ``BatchNorm2d`` in place by `convert_sync_batchnorm`, so parameters,
    buffers and state_dict names stay the same."""

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c)
        stats = all_reduce_sum(torch.cat([x.sum((0, 2, 3)), count]), self.process_group)
        mean = stats[:c] / stats[c]
        d = x - mean[None, :, None, None]
        var = all_reduce_sum((d * d).sum((0, 2, 3)), self.process_group) / stats[c]
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach().to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.detach().to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked.add_(1)
        y = d * torch.rsqrt(var + self.eps)[None, :, None, None]
        if self.affine:
            y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        return y


def convert_sync_batchnorm(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Turn every ``models.layers.BatchNorm2d`` of `module` into a
    `SyncBatchNorm2d` over `group`, in place; returns `module`."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.__class__ = SyncBatchNorm2d
            m.process_group = group
    return module
