"""The controls of the cells' checks, and the program's readings of the
compared numbers, each judged by the cell's own check.

  python3 -m portbench.control --workload <cell> --seeds 11,12,13 [--program] [--device cuda]

A control is the reference put in the program's place and computed one
precision below the configuration's; its answers go through the cell's
driver's ``verify`` and ``harness.checks``, as a run's answers do, and a
sound check reads ``correct`` false for it. With ``--program`` (extract
cells) the program's own answers of one timed-size call are judged
instead: the readings a limit is set above, many seeds in one process.
Prints one JSON line per seed: ``correct`` and each compared number
beside its limit.

* serve cells (float32 matching and pose): TF32. Over the same sample of
  queries a run checks, each query's matches against its retrieved DB
  images and its pose (Gauss-Newton from the TF32 matches), every product
  of TF32 operands summed in float32.
* extract cells (bfloat16 trunk): fp8. The reference network with every
  convolution's input and weight rounded to float8 e4m3, one scale per
  tensor, and its own keypoint selection.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys

import numpy as np
import torch

from portbench import harness
from portbench.reference.localize import correspondences, reference_pose
from portbench.reference.match import bank_valid, mutual_matches, similarities
from portbench.reference.sfd2 import Net
from portbench.scene import make_scene, map_arrays, retrieval, sub_seed
from portbench.weights import make_state_dict

Features = collections.namedtuple("Features", "keypoints scores descriptors")


class full_precision:
    """TF32 off in matmuls and cuDNN convolutions inside the block (the
    references' setting) or, with ``False``, the flags the process started
    with (a run's window)."""

    START = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    def __init__(self, on: bool = True):
        self.flags = (False, False) if on else self.START

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.flags

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def serve_control(cell, seed: int, device) -> dict:
    """The compared numbers of TF32 answers to the first queries of the seed's order."""
    from portbench.drivers import serve

    loc = cell.config["localizer"]
    size = serve.scene_size(cell.config)
    scene = make_scene(size, seed, device)
    prow, point_xyz, track_len = map_arrays(scene)
    retr = retrieval(scene, loc["retrieval_topk"])
    order = np.random.default_rng(sub_seed(seed, 3)).permutation(size.n_q)
    dev = torch.device(device)
    answered, replies, recorded = [], {}, {}
    for i, q in enumerate(order[:cell.mix["check_requests"] + 1]):
        q, rows = int(q), retr[q]
        qd = torch.from_numpy(np.ascontiguousarray(scene.q_desc[q].T)).to(dev)
        qv = torch.arange(size.kp, device=dev) < int(scene.q_nv[q])
        ms = []
        for lo in range(0, len(rows), serve.BANK_BLOCK):
            r = rows[lo:lo + serve.BANK_BLOCK]
            banks = torch.from_numpy(np.ascontiguousarray(
                scene.db_desc[r].transpose(0, 2, 1))).to(dev)
            bv = torch.from_numpy(bank_valid(scene.db_nv[r], prow[r])).to(dev)
            ms.append(mutual_matches(similarities(qd, banks, qv, bv, "tf32")).cpu().numpy())
        recorded[serve.query_name(q)] = [(list(rows + 1), np.concatenate(ms).astype(np.int32))]
        uv, xyz = correspondences(scene.q_desc[q], scene.q_nv[q], scene.q_kp[q],
                                  scene.db_desc[rows], scene.db_nv[rows], prow[rows],
                                  point_xyz, track_len, loc["obs_thresh"], "tf32", device)
        qvec, tvec, _ = reference_pose(scene.q_q[q], scene.q_t[q], uv, xyz, size.cam_params,
                                       loc["opt_thresh"], "tf32", device)
        replies[i] = {"qvec": np.asarray(qvec).tolist(), "tvec": np.asarray(tvec).tolist()}
        answered.append((i, q, 0.0, 1.0, 200, b""))
    ctx = dict(cell=cell, seed=seed, device=device)
    return serve.verify(ctx, scene, prow, point_xyz, track_len, retr, answered, replies,
                        recorded)


def extract_control(cell, seed: int, device) -> dict:
    """The compared numbers of the fp8 network's features of the images a check samples."""
    from portbench.drivers import extract

    knobs, mix = cell.config["extraction"], cell.mix
    state = make_state_dict(seed, device)
    pool_u8 = extract.make_images(mix["pool_images"], mix["height"], mix["width"], seed, device)
    ctrl = Net(state, "fp8")
    idx = np.random.default_rng(sub_seed(seed, 6)).choice(len(pool_u8), mix["check_images"],
                                                           replace=False)
    feats = [Features(*extract.reference_outputs(ctrl, pool_u8[i], knobs,
                                                 knobs["pad_multiple"], device)[1])
             for i in idx]
    del ctrl
    ctx = dict(cell=cell, seed=seed, device=device)
    return extract.verify(ctx, state, pool_u8, {0: (idx, feats)})


def extract_program(cell, seed: int, device) -> dict:
    """The compared numbers of one ``extract_batch`` call of the window's
    size, on the seed's weights and images: a sound run's readings."""
    from portbench.drivers import extract

    mix = cell.mix
    state = make_state_dict(seed, device)
    pool_u8 = extract.make_images(mix["pool_images"], mix["height"], mix["width"], seed, device)
    idx = np.random.default_rng(sub_seed(seed, 6)).choice(len(pool_u8), mix["batch_images"],
                                                           replace=False)
    extractor = extract.make_extractor(cell, state, device)
    with full_precision(False):  # the program runs with the flags a run's window has
        feats = extractor.extract_batch([pool_u8[i].astype(np.float32) / 255.0 for i in idx])
    del extractor
    ctx = dict(cell=cell, seed=seed, device=device)
    return extract.verify(ctx, state, pool_u8, {0: (idx, feats)})


CONTROLS = {"serve": serve_control, "extract": extract_control}
PROGRAM = {"extract": extract_program}


def judge(cell, seed: int, device, program: bool = False) -> dict:
    """{"correct", "checks", "info"} of the control's (or the program's) answers."""
    table = PROGRAM if program else CONTROLS
    with full_precision():
        numbers = table[cell.mix["driver"]](cell, seed, device)
    compared, ok = harness.checks(numbers, cell.limits)
    return {"correct": ok, "checks": compared,
            "info": {k: v for k, v in numbers.items() if k not in cell.limits}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.resolve(harness.load_manifest(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = judge(cell, seed, args.device, args.program)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "side": "program" if args.program else "control", **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
