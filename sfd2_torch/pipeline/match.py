"""Pair-list matching pipeline (features → match store).

Port of ``sfd2_tpu/pipeline/match.py`` (``hloc/match_features.py``
parity): match every pair of a list, skip pairs already in the store and
reversed duplicates (``:94-97``), write ``matches0``/``matching_scores0``
groups. Matcher presets mirror ``it_loc/matcher.py:24``: NNM mutual NN
(kernel K2), NNR ratio 0.9 (kernel K4), ONN one-way, NNML label-aware.

Pairs are matched in batches of ``batch_size`` over padded [K] banks, one
matcher launch per batch. A batch's banks that miss the call's LRU of
device banks are staged first (span ``match.stage``, counter
``match.banks_staged``): each is read as the store holds it
(``FeatureStore.read_stored``: hloc's [C, N], float16 under ``as_half``,
no host copy from a dict store), uploaded as it is, and laid out on the
device into a zero-filled float32 [K, C] bank (the first K keypoints) with
its [K] valid mask built from N. The host neither transposes nor pads a
descriptor. Each batch's (matches, scores) come back in one packed
transfer (counter ``match.pairs_matched``). With a ``mesh``
(``parallel/mesh.py``) the banks live on the mesh's first device, and each
batch is padded to a multiple of the mesh's ``data`` axis with all-invalid
pairs and split over the mesh (``ops/sharded_match.py``), one launch per
device.
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
from sfd2_torch.utils.profiling import count, span

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

    Banks reach the device as the store holds them: a batch's banks that
    are not in the call's device LRU (``_DEV_CACHE_IMAGES`` banks) are
    read with ``read_stored``, uploaded each in one copy, and transposed,
    cast to float32 and zero-padded to [K, C] there; their valid masks are
    built from the keypoint counts. K2 gets the numbers ``read_padded``
    would give, in the same order.

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

    n_real: Dict[str, int] = {}  # valid keypoints, the length of a pair's matches0
    dev_cache: "OrderedDict[str, tuple]" = OrderedDict()
    cols = torch.arange(k, device=dev)

    def stage(name):
        """(bank [K, C] float32, valid [K], labels [K] int32 or None) on `dev`."""
        got = features.read_stored(name, with_labels=with_labels)
        n = n_real[name] = min(got.num, k)
        src = torch.from_numpy(np.ascontiguousarray(got.descriptors)).to(dev)
        if got.channels_first:
            src = src.T
        bank = torch.zeros((k, src.shape[1]), dtype=torch.float32, device=dev)
        bank[:n] = src[:n]
        labels = None
        if with_labels:
            lb = np.zeros((k,), np.int32)
            if got.labels is not None:
                lb[:n] = got.labels[:n]
            labels = torch.from_numpy(lb).to(dev)
        return bank, cols < n, labels

    done = 0
    for i in range(0, len(todo), cfg.batch_size):
        chunk = todo[i: i + cfg.batch_size]
        names = [n0 for n0, _ in chunk] + [n1 for _, n1 in chunk]
        banks = {n: dev_cache[n] for n in names if n in dev_cache}
        new = [n for n in dict.fromkeys(names) if n not in banks]
        if new:
            with span("match.stage", banks=len(new)):
                banks.update((n, stage(n)) for n in new)
            count("match.banks_staged", len(new))
        for n in names:  # the LRU in the order the batch takes its banks
            if n in dev_cache:
                dev_cache.move_to_end(n)
            else:
                dev_cache[n] = banks[n]
                if len(dev_cache) > _DEV_CACHE_IMAGES:
                    dev_cache.popitem(last=False)
        e0 = [banks[n0] for n0, _ in chunk]
        e1 = [banks[n1] for _, n1 in chunk]
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
            n = n_real[n0]
            store.write(n0, n1, ms[bi, :n, 0].astype(np.int32), ms[bi, :n, 1])
        count("match.pairs_matched", len(chunk))
        done += len(chunk)
    return done
