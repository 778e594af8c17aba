"""Sharded descriptor matching over a device mesh.

Port of ``sfd2_tpu/ops/sharded_match.py`` ("DB descriptor bank sharded
across chips for matching: each chip matches the query against its
shard, all_gather top candidates"):

* `query_vs_sharded_bank` — one query against D candidate DB banks whose
  leading axis is split over the mesh: the query is copied to every
  device, each device launches the batched matcher (kernel K2 with the
  query broadcast, or the label-aware plain version) on its own banks,
  and the per-bank results are gathered on the first device.
* `make_sharded_pair_matcher` — DB-DB pair matching: the pair batch is
  split; each device matches its pairs (K2 for 'nnm', K4 for 'nnr', the
  plain versions for 'onn' and 'nnml').

Pairs are independent in every matcher (the kernels' 64-bit atomic
merges are exact), so both give bit for bit what one device gives on the
whole batch.
"""

from __future__ import annotations

import torch

from sfd2_torch.ops.matching import batch_matcher
from sfd2_torch.parallel.mesh import Mesh, to_tensor, gather_batch, put_batch


def query_vs_sharded_bank(mesh: Mesh, q_desc, bank_desc, q_valid, bank_valid,
                          q_labels=None, bank_labels=None, axis: str = "data"):
    """Match one query (q_desc [K, C], q_valid [K], q_labels [K]) against D
    DB banks (bank_desc [D, K', C], bank_valid [D, K'], bank_labels [D, K'])
    split over `axis`. D must be divisible by the axis size (pad with
    all-invalid banks). Returns (matches [D, K] int32 with −1 for no
    match, scores [D, K]) on the axis's first device."""
    n = mesh.shape[axis]
    if bank_desc.shape[0] % n:
        raise ValueError(f"bank D={bank_desc.shape[0]} not divisible by mesh axis {n}")
    with_labels = q_labels is not None and bank_labels is not None
    match = batch_matcher("nnml" if with_labels else "nnm")
    banks = [bank_desc, bank_valid] + ([bank_labels] if with_labels else [])
    q = [to_tensor(q_desc), to_tensor(q_valid)] + ([to_tensor(q_labels)] if with_labels else [])
    out = []
    for shard in put_batch(mesh, banks, axis):
        d = shard[0].shape[0]
        dev = shard[0].device
        qd, qv, *ql = (t.to(dev) for t in q)
        args = [qd.to(shard[0].dtype)[None].expand(d, *qd.shape), shard[0],
                qv[None].expand(d, qv.shape[0]), shard[1]]
        if with_labels:
            args += [ql[0][None].expand(d, ql[0].shape[0]), shard[2]]
        out.append(match(*args))
    first = mesh.axis_devices(axis)[0]
    return (gather_batch([m for m, _ in out], first),
            gather_batch([s for _, s in out], first))


def make_sharded_pair_matcher(mesh: Mesh, mode: str = "nnm", ratio: float = 0.9,
                              axis: str = "data"):
    """Batched pair matcher with the pair axis split over the mesh: a
    callable (d0 [B,K,C], d1, v0, v1[, l0, l1]) → (matches, scores) on the
    axis's first device; B must be divisible by the axis size."""
    fn = batch_matcher(mode, ratio)

    def run(*arrays):
        n = mesh.shape[axis]
        if arrays[0].shape[0] % n:
            raise ValueError(f"pair batch {arrays[0].shape[0]} not divisible by mesh axis {n}")
        out = [fn(*shard) for shard in put_batch(mesh, list(arrays), axis)]
        first = mesh.axis_devices(axis)[0]
        return (gather_batch([m for m, _ in out], first),
                gather_batch([s for _, s in out], first))

    return run
