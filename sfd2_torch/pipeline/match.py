"""Pair-list matching pipeline (features → match store).

Port of ``sfd2_tpu/pipeline/match.py`` (``hloc/match_features.py``
parity): match every pair of a list, skip pairs already in the store and
reversed duplicates (``:94-97``), write ``matches0``/``matching_scores0``
groups. Matcher presets mirror ``it_loc/matcher.py:24``: NNM mutual NN
(kernel K2), NNR ratio 0.9 (kernel K4), ONN one-way, NNML label-aware.

Pairs are matched in batches of ``batch_size`` over padded [K] banks, one
matcher launch per batch. Each image's bank is uploaded once into an LRU
device cache, and each batch's (matches, scores) come back in one packed
transfer. With a ``mesh`` (``parallel/mesh.py``) the cache lives on the
mesh's first device, and each batch is padded to a multiple of the mesh's
``data`` axis with all-invalid pairs and split over the mesh
(``ops/sharded_match.py``), one launch per device.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from sfd2_torch.io.feature_store import FeatureStore, MatchStore
from sfd2_torch.ops.matching import batch_matcher
from sfd2_torch.utils.device import resolve_device

MATCHER_CONFS: Dict[str, dict] = {
    "NNM": {"mode": "nnm"},
    "NNR": {"mode": "nnr", "ratio": 0.9},
    "ONN": {"mode": "onn"},
    # Label-aware mutual NN (``it_loc/matcher.py:24,239``): a labeled
    # feature never matches a differently-labeled one.
    "NNML": {"mode": "nnml"},
}

_DEV_CACHE_IMAGES = 1024


@dataclasses.dataclass
class MatchConfig:
    matcher: str = "NNM"
    max_keypoints: int = 4096
    batch_size: int = 16


def match_pairs(features: FeatureStore, pairs: Sequence[Tuple[str, str]], store: MatchStore,
                cfg: MatchConfig = MatchConfig(), mesh=None, device="cuda") -> int:
    """Match all pairs into `store`; resumable; returns #matched.

    `mesh`: an optional ``parallel.mesh.Mesh`` with a 'data' axis, over
    which each pair batch is split (then `device` is not used: banks are
    cached on the axis's first device)."""
    conf = MATCHER_CONFS[cfg.matcher]
    if mesh is not None:
        from sfd2_torch.ops.sharded_match import make_sharded_pair_matcher
        from sfd2_torch.parallel.mesh import Mesh, shard_batch

        if not isinstance(mesh, Mesh):
            raise TypeError(f"match_pairs: mesh must be a parallel.mesh.Mesh, not {type(mesh)}")
        fn = make_sharded_pair_matcher(mesh, conf["mode"], conf.get("ratio", 0.9))
        dev = shard_batch(mesh)[0]
        n_dev = mesh.shape["data"]
    else:
        dev = resolve_device(device)
        fn = batch_matcher(conf["mode"], conf.get("ratio", 0.9))
        n_dev = 1
    with_labels = conf["mode"] == "nnml"
    k = cfg.max_keypoints

    todo = []
    seen = set()
    for n0, n1 in pairs:
        if (n0, n1) in seen or (n1, n0) in seen:
            continue
        seen.add((n0, n1))
        if not store.has_pair(n0, n1):
            todo.append((n0, n1))

    cache: Dict[str, tuple] = {}

    def feats(name):
        if name not in cache:
            _, de, _, va, lb = features.read_padded(name, k, with_labels=True)
            cache[name] = (de, va, int(va.sum()), lb)
        return cache[name]

    dev_cache: "OrderedDict[str, tuple]" = OrderedDict()

    def feats_dev(name):
        if name in dev_cache:
            dev_cache.move_to_end(name)
        else:
            de, va, _, lb = feats(name)
            dev_cache[name] = (torch.from_numpy(de).to(dev), torch.from_numpy(va).to(dev),
                               torch.from_numpy(lb).to(dev) if with_labels else None)
            if len(dev_cache) > _DEV_CACHE_IMAGES:
                dev_cache.popitem(last=False)
        return dev_cache[name]

    count = 0
    for i in range(0, len(todo), cfg.batch_size):
        chunk = todo[i: i + cfg.batch_size]
        e0 = [feats_dev(n0) for n0, _ in chunk]
        e1 = [feats_dev(n1) for _, n1 in chunk]
        pad = -(-len(chunk) // n_dev) * n_dev - len(chunk)  # all-invalid pairs: whole shares
        if pad:
            e0 += [tuple(t if t is None else torch.zeros_like(t) for t in e0[0])] * pad
            e1 += [tuple(t if t is None else torch.zeros_like(t) for t in e1[0])] * pad
        args = [torch.stack([e[0] for e in e0]), torch.stack([e[0] for e in e1]),
                torch.stack([e[1] for e in e0]), torch.stack([e[1] for e in e1])]
        if with_labels:
            args += [torch.stack([e[2] for e in e0]), torch.stack([e[2] for e in e1])]
        m, s = fn(*args)
        # One fetch per batch: indices are < 2^24, exact in float32.
        ms = torch.stack([m.to(torch.float32), s], dim=-1).cpu().numpy()
        for bi, (n0, n1) in enumerate(chunk):
            n_real = feats(n0)[2]
            store.write(n0, n1, ms[bi, :n_real, 0].astype(np.int32), ms[bi, :n_real, 1])
            count += 1
    return count
