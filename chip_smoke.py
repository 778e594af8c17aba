"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root:  python3 chip_smoke.py

Builds every CUDA kernel from ``sfd2_torch/csrc`` (K1 fused stem, K2
mutual-NN matcher, K3 row gather, K4 mutual-NN + ratio matcher, K5
bidirectional argmax, K6 bidirectional top-2; K1's conv1b and the four
matchers K2, K4, K5 and K6, which share ``csrc/nn_tc.cuh``, run on the
tensor cores and must hold wgmma instructions, HGMMA in their SASS), holds
each against its plain PyTorch version at the main paths' shapes, with its
bounds on the CUDA cores and on the tensor cores (K3 also replayed from a
CUDA graph, ``graph_ms``), then drives the main paths:
- the query path: ``Extractor`` on four 1024² images with the full-width
  ResSegNetV2 (random weights from a seed), and
  ``LocalizationEngine.localize`` on the synthetic corridor scene at the
  production query shapes (4096 keypoints, 50 retrieved frames, C=128),
  then the engine's throughput paths on the same 8 queries:
  ``localize_many`` (4 worker threads, bit-identical to the sequential
  pass) and ``localize_throughput`` (every device stage once for all
  queries), with the qps figures of ``bench.py``; PnP-RANSAC and the
  refinement replay CUDA graphs captured once per padded shape
  (``localization/graphs.py``), and ``pnp_graph`` holds one batch of each
  against the same programs run eagerly on the card;
- multi-scale, labelled extraction at ``sfd2-n4096-r1600-ms`` on four
  1600×1200 images with label maps (K1 at [4,1216,1600,3],
  [4,1024,1344,3] and [4,896,1152,3]; labelled keypoints first);
- serving: ``LocalizationService`` warmed up behind ``make_server`` in a
  thread, the 8 queries POSTed from 4 client threads, every answer equal
  to the engine's;
- the localizer front end (``localize_queries``, ``write_results``) on the
  same queries from a written model and text query/retrieval lists: poses
  bit-identical to the engine's, recall ≥ 0.875, one run traced by
  ``utils/profiling.trace``; and InLoc (``localize_rgbd``) of the same
  queries against rendered RGB-D scans (K2 over the retrieved frames);
- map building on the same scene (60 DB images, 4096 keypoints, C=128):
  covisibility pairs → ``match_pairs`` (K2) → ``triangulate_map``
  (F-RANSAC, tracks on the native union-find, held against the Python
  rule's roots, triangulation) → a map bundle adjustment (K3);
- ``incremental_reconstruction`` from scratch on its first 12 images,
  matched with the NNR preset (K4), with bundle adjustment (K3);
- in both map phases every ``bundle_adjust`` call (its LM iterations
  replayed from a CUDA graph) is run again through the same LM iteration
  stepped eagerly on the card (``ba_eager_s``): costs, poses and points
  within 1e-4; and run a second time, graph and eager alike, without
  deterministic algorithms: the same bits (BA sums in one fixed order);
- ``match_pairs`` on the large-bank route: 3 images × 68,992 keypoints ×
  C=128 and 3 × 19,584 × C=512 (D2-Net's width; each the first bank size
  the JAX package sends to its tiled kernels at that width), pairs (0,1),
  (0,2), (1,2), with NNM (K5) and then NNR (K6), held against the plain
  versions on sampled rows and columns and against the planted true
  matches;
- the baseline extractors (``pipeline/extractors.py::dynamic_load(...,
  device="cuda")``, seeded full-width networks): SuperPoint, R2D2, D2-Net,
  SGD2 and SFD2 (K1) on 8 textured 1024×768 images (images 1–3 crops of
  one texture moved by (64, 32) px each), CAPS's network at SuperPoint's
  keypoints (``caps_describe``; its OpenCV detector is host-only), each
  network also on a 192×256 crop on the CPU with the same weights in
  float32; then ``match_pairs`` over the 28 pairs: SuperPoint NNM (K2,
  C=256), R2D2 NNM (K2, C=128), D2-Net NNR (K4, C=512), SuperPoint NNR
  (K4, C=256), and the planted shift recovered (SuperPoint NNM ≥ 95 %);
- DIR retrieval: ``make_dir`` (ResNet-101 GeM, 2048-D, float32) on 16
  DB images and 8 noisy copies as queries, ``pairs_from_retrieval`` (each
  query's first pair its source) and ``pca_whiten``;
- training: ``Trainer`` with the shipped loss configuration on seeded
  full-width ResSegNetV2 and SuperPoint, the online ConvNeXt-B UPerNet
  teacher, 512² crops of 20 textured 1024×768 images, batch 4: 2 epochs ×
  5 steps timed stage by stage, a resume and a third epoch, one injected
  NaN batch (``train``); the convergence recipe of
  ``tests/test_convergence.py`` and one step against the CPU
  (``train_converge``); the trained ``last.ckpt`` through ``Extractor``
  (K1 at [4,1024,1024,3]) against the unfused stem (``train_extract``);
- training's data sources (``train_sources``): an Aachen layout and a
  debug folder written to disk, label maps from the seeded segmentor
  (``cli/segment_images.py::segment_folder``), ``Trainer`` over
  ``build_data_source("DSF")`` with those labels;
- the mesh (``mesh``), right after ``localize``: meshes of the card's
  devices and of four entries of cuda:0; sharded matching (K2 at
  [64,4096,128] and [16,4096,128], K4 at [16,4096,128]) bit-identical to
  the unsharded kernels, ``localize`` with a mesh bit-identical to the
  ``localize`` phase, ``Extractor`` over the mesh (K1), and one
  data-parallel train step at world size 1 over ``nccl``;
- ResBlock's grouped 3×3 conv (``models/layers.py::GroupedConvAsDense``)
  in its two forms, cuDNN's groups=32 conv and the JAX package's coarse
  block-diagonal conv: compared on the card in f32 at [4,256,128,128],
  stride 1 and 2, and timed at the train step's and extraction's shapes
  (``grouped_conv``); ``train`` and ``extract`` also run and trace their
  step or batch in both forms, in turns.
Every kernel's launch count and launch-shape record is set to 0 just
before each path and read just after. A shape a main path launched that
the kernel phases did not compare is compared afterwards, so every launch
shape is held against the plain version. Each phase prints one JSON line;
any failed check raises and the script exits non-zero without a result.
Every phase line carries ``peak_mem_mb``, the most device memory
allocated since the previous line. The last three lines are the kernel
table (JSON), the card's name and power limit as nvidia-smi gives them, and
``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Exits non-zero when CUDA is
not available.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from sfd2_torch.cli.segment_images import segment_folder
from sfd2_torch.geometry.cameras import Camera, canonicalize_params
from sfd2_torch.geometry.np_pose import camera_center, pose_error
from sfd2_torch.geometry.pose import pose_error as pose_error_tensors
from sfd2_torch.geometry.pose import recall_at_thresholds
from sfd2_torch.io.colmap_model import Image, read_model, write_model
from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures, MatchStore
from sfd2_torch.io.pairs import parse_image_lists_with_intrinsics, parse_retrieval
from sfd2_torch.localization import graphs
from sfd2_torch.localization.engine import LocalizationEngine, LocalizerConfig
from sfd2_torch.localization.inloc import localize_rgbd
from sfd2_torch.localization.localizer import (LocalizerRun, load_gt_poses, localize_queries,
                                               write_results)
from sfd2_torch import native
from sfd2_torch.models.baselines import CapsResUNet
from sfd2_torch.models.layers import GroupedConvAsDense
from sfd2_torch.models.retrieval import pca_whiten
from sfd2_torch.models.sfd2 import ResSegNetV2
from sfd2_torch.ops import cuda_build
from sfd2_torch.ops.cuda_gather import gather_rows_cuda, graph_capture_record
from sfd2_torch.ops.cuda_match import mutual_nn_match_cuda
from sfd2_torch.ops.cuda_match_ratio import mutual_nn_ratio_match_cuda
from sfd2_torch.ops.cuda_nn_argmax import nn_argmax_cuda
from sfd2_torch.ops.cuda_nn_top2 import nn_top2_cuda
from sfd2_torch.ops.cuda_stem import StemWeights, fused_stem_cuda, stem_launch, stem_lib
from sfd2_torch.ops.gather import gather_rows_plain
from sfd2_torch.ops.matching import (mutual_nn_match, mutual_nn_match_with_labels,
                                    mutual_nn_ratio_match, nn_argmax, nn_top2, tiled_route)
from sfd2_torch.ops.sharded_match import make_sharded_pair_matcher, query_vs_sharded_bank
from sfd2_torch.parallel import make_mesh
from sfd2_torch.parallel.distributed import convert_sync_batchnorm, init_process_group
from sfd2_torch.ops.stem import fused_stem_apply, repack_stem_params, unpack_stem_params
from sfd2_torch.pipeline.extract import EXTRACTION_CONFS, ExtractionConfig, Extractor
from sfd2_torch.pipeline.extractors import (BaselineConfig, build_model, caps_describe, dynamic_load,
                                            seeded_init_)
from sfd2_torch.pipeline.match import MatchConfig, match_pairs
from sfd2_torch.sfm import pipeline as sfm_pipeline
from sfd2_torch.sfm import reconstruction as sfm_reconstruction
from sfd2_torch.sfm.ba import BAProblem, bundle_adjust, lm_result, lm_setup
from sfd2_torch.sfm.map_index import MapIndex
from sfd2_torch.sfm.pairs import pairs_from_covisibility, pairs_from_retrieval
from sfd2_torch.sfm.pipeline import TriangulationConfig, triangulate_map
from sfd2_torch.sfm.reconstruction import ReconstructionConfig, incremental_reconstruction
from sfd2_torch.serving.server import LocalizationService, make_server
from sfd2_torch.sfm.tracks import track_edges, union_find_roots_plain
from sfd2_torch.utils.profiling import trace
from sfd2_torch.utils.synth import build_corridor_scene
from sfd2_torch.models.superpoint import SuperPoint
from sfd2_torch.models.upernet import Segmentor, SegmentorConfig, seeded_segmentor
from sfd2_torch.pipeline import extract as pipeline_extract
from sfd2_torch.training.data import (ArrayDataset, PairLoader, PrecomputedPairBuilder,
                                      SyntheticPairBuilder, warp_perspective)
from sfd2_torch.training.datasets_aachen import build_data_source
from sfd2_torch.training.flow_pairs import flow_to_png, png_to_flow
from sfd2_torch.training.losses import SegLossConfig
from sfd2_torch.training.sampler import NghSampler2DS
from sfd2_torch.training.seg_teacher import (LabelDirPairs, LabelDirTeacher, SegTeacher,
                                             SegTeacherLoader)
from sfd2_torch.training.train_step import (TrainBatch, TrainConfig, TrainState, guarded_state,
                                            make_optimizer, make_train_step, set_lr)
from sfd2_torch.training.trainer import Trainer, TrainerConfig, batch_to_device, load_model_state
from sfd2_torch.utils.benchtime import cuda_fence, measure_rtt, timed_per_item
from sfd2_torch.utils.image_io import write_png

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores,
# dense TF32 and bf16 on the tensor cores, and HBM bandwidth. The bound of
# a kernel is the larger of its operations over a peak and its bytes over
# the bandwidth. K3's is its bytes; K1's and the matchers' bounds are
# `matcher_bounds`.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SEED = 0

KERNELS = {
    "fused_stem": dict(route="cuda", source="sfd2_torch/csrc/stem.cu",
                       replaces="sfd2_tpu/ops/pallas_stem.py:216", wrapper=fused_stem_cuda),
    "mutual_nn_match": dict(route="cuda", source="sfd2_torch/csrc/match.cu",
                            replaces="sfd2_tpu/ops/pallas_match.py:358",
                            wrapper=mutual_nn_match_cuda),
    "gather_rows": dict(route="cuda", source="sfd2_torch/csrc/gather.cu",
                        replaces="sfd2_tpu/ops/pallas_gather.py:114", wrapper=gather_rows_cuda),
    "mutual_nn_ratio_match": dict(route="cuda", source="sfd2_torch/csrc/match_ratio.cu",
                                  replaces="sfd2_tpu/ops/pallas_match.py:647",
                                  wrapper=mutual_nn_ratio_match_cuda),
    "nn_argmax": dict(route="cuda", source="sfd2_torch/csrc/nn_argmax.cu",
                      replaces="sfd2_tpu/ops/pallas_match.py:126", wrapper=nn_argmax_cuda),
    "nn_top2": dict(route="cuda", source="sfd2_torch/csrc/nn_top2.cu",
                    replaces="sfd2_tpu/ops/pallas_match.py:540", wrapper=nn_top2_cuda),
}


def emit(phase: str, **fields):
    """One JSON line; ``peak_mem_mb`` is the most device memory allocated
    since the previous line (the peak is reset after each), or more where
    the phase passes a larger peak it read before resetting it itself."""
    if torch.cuda.is_initialized():
        fields["peak_mem_mb"] = max(fields.get("peak_mem_mb", 0.0),
                                    torch.cuda.max_memory_allocated() / 2**20)
        torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median device time of fn() over `iters` runs, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms_per_call(fn, iters: int = 20) -> float | None:
    """Device time of one call of fn: the summed time of the kernels that
    `iters` calls launched, from a torch.profiler trace, over `iters` —
    the kernels alone, without the host's dispatch that CUDA events
    around a microsecond-scale call also measure. None if the trace holds
    no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / iters if total else None


def graph_ms(fn, n: int = 100) -> float:
    """Device time of one call of fn inside a CUDA graph of n calls: the
    graph replayed (``cuda_ms``), over n. The host dispatches the graph
    once, so this is the call's time where a graph launches it (bundle
    adjustment's LM iterations). The captured launches are measurements
    and leave the launch counts as they were."""
    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), graph_capture_record():
        graph.capture_begin()
        for _ in range(n):
            fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return cuda_ms(graph.replay) / n


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def matcher_bounds(flops: float, nbytes: float, nbytes_bf16: float | None) -> dict:
    """Bounds of a tensor-core kernel (K1, K2, K4, K5, K6). `bound_ms`: f32
    inputs at f32 accuracy on the tensor cores, as 3×TF32 (three products
    per term, so the TF32 peak ÷ 3), the least time the card takes for
    this work and the path these kernels take; `bf16_tc_bound_ms` (the
    matchers): bf16 inputs (nbytes_bf16) at the bf16 peak;
    `cuda_core_bound_ms`: f32 FMA on the CUDA cores, the least time of a
    kernel that keeps off the tensor cores."""
    ms, by = bound(flops, nbytes, PEAK_TF32_FLOPS / 3)
    cc_ms, cc_by = bound(flops, nbytes)
    out = dict(bound_ms=ms, bound_by=by, bound_peak="TF32 495 TFLOP/s / 3 (3xTF32)",
               cuda_core_bound_ms=cc_ms, cuda_core_bound_by=cc_by, cuda_core_peak="f32 67 TFLOP/s")
    if nbytes_bf16 is not None:
        bf_ms, bf_by = bound(flops, nbytes_bf16, PEAK_BF16_FLOPS)
        out.update(bf16_tc_bound_ms=bf_ms, bf16_tc_bound_by=bf_by, bf16_tc_peak="bf16 989 TFLOP/s")
    return out


def random_model_state(seed: int):
    """Full-width ResSegNetV2 with seeded random weights and randomised BN
    running statistics (so the BN folds are not identities)."""
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    model = ResSegNetV2()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.3)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return model.state_dict()


def reset_launches():
    for k in KERNELS.values():
        k["wrapper"].launches = 0
        k["wrapper"].shapes.clear()


def read_launches() -> dict:
    """{kernel: Counter of launch shapes} since the last reset_launches()."""
    return {name: collections.Counter(k["wrapper"].shapes) for name, k in KERNELS.items()}


def phase_build(results):
    t0 = time.perf_counter()
    logs = cuda_build.build()
    for name in cuda_build.kernel_sources():
        cuda_build.load(name)
    # K1's stage-A-only variant, timed beside K1 for conv1a's share.
    logs.update({f"stem+{STEM_CONV1A_ONLY[0]}": log
                 for log in cuda_build.build(["stem"], STEM_CONV1A_ONLY).values()})
    stem_lib(STEM_CONV1A_ONLY)
    # The host union-find library of track building (g++), built here so
    # that map_build's tracks_s times the stage and not the compiler.
    t1 = time.perf_counter()
    native.get_lib()
    native_build_s = time.perf_counter() - t1
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    # The tensor-core kernels must hold wgmma (SASS HGMMA) instructions;
    # FFMA counts the f32 FMAs left on the CUDA cores (K1: conv1a).
    sass = {}
    for name in ("stem", "match", "match_ratio", "nn_argmax", "nn_top2"):
        dump = cuda_build.sass(name)
        sass[name] = {op: dump.count(op) for op in ("HGMMA", "HMMA", "FFMA")}
        require(sass[name]["HGMMA"] > 0, f"{name}: no HGMMA instruction in its library")
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         sources=cuda_build.kernel_sources(), native_build_s=native_build_s, ptxas=ptxas,
         sass=sass)


STEM_CONV1A_ONLY = ("STEM_CONV1A_ONLY",)  # csrc/stem.cu built without stage B


class StemCase:
    """K1 against its plain version at one input shape, on the card."""

    def __init__(self, state):
        dev = torch.device("cuda")
        self.weights = StemWeights(repack_stem_params(state), dev)
        w1, self.b1, w2, self.b2 = (t.to(dev) for t in unpack_stem_params(self.weights.packed))
        self.w1c = w1.permute(3, 2, 0, 1).contiguous()
        self.w2c = w2.permute(3, 2, 0, 1).contiguous()

    def __call__(self, b: int, h: int, w: int) -> dict:
        weights = self.weights
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn((b, h, w, 3), generator=gen, device="cuda")
        ref = fused_stem_apply(x, weights.packed, torch.float32)
        got = fused_stem_cuda(x, weights, torch.float32)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-6)
        require(rel <= 1e-4, f"K1 f32 rel err {rel} > 1e-4 at {(b, h, w)}")
        got16 = fused_stem_cuda(x, weights, torch.bfloat16).float()
        rel16 = (got16 - ref).abs().max().item() / max(ref.abs().max().item(), 1e-6)
        require(rel16 <= 1e-2, f"K1 bf16-out rel err {rel16} > 1e-2 (bf16 rounding 2^-8)")
        xc = x.permute(0, 3, 1, 2).contiguous()

        def library():
            a = torch.relu(torch.nn.functional.conv2d(xc, self.w1c, self.b1, padding=1))
            return torch.relu(torch.nn.functional.conv2d(a, self.w2c, self.b2, stride=2, padding=1))

        flops_1a = b * 2 * 27 * 64 * h * w
        flops = flops_1a + b * 2 * 576 * 64 * (h // 2) * (w // 2)
        nbytes = b * (h * w * 3 * 4 + (h // 2) * (w // 2) * 64 * 2)  # bf16 out
        scratch = torch.empty((b, h // 2, w // 2, 64), dtype=torch.bfloat16, device="cuda")
        variant = stem_lib(STEM_CONV1A_ONLY)
        ms = cuda_ms(lambda: fused_stem_cuda(x, weights, torch.bfloat16))
        conv1a_ms = cuda_ms(lambda: stem_launch(variant, x, weights, scratch))
        row = dict(
            shape=[b, h, w, 3], max_abs_err=err, max_rel_err=rel, bf16_out_rel_err=rel16,
            ms=ms, f32_out_ms=cuda_ms(lambda: fused_stem_cuda(x, weights, torch.float32)),
            plain_ms=cuda_ms(lambda: fused_stem_apply(x, weights.packed, torch.float32)),
            library_ms=cuda_ms(library), gflop=flops / 1e9, mbytes=nbytes / 1e6,
            **matcher_bounds(flops, nbytes, None),
            # conv1a (16 % of the operations, on the FMA units) alone: the
            # kernel built without stage B, its share of ms
            conv1a_flop_share=flops_1a / flops, conv1a_only_ms=conv1a_ms,
            conv1a_share=conv1a_ms / ms,
            kernel_device_ms=device_ms_per_call(
                lambda: fused_stem_cuda(x, weights, torch.bfloat16)),
            library_device_ms=device_ms_per_call(library))
        emit("kernel_stem", **row)
        return row


def phase_kernel_stem(results, state):
    case = StemCase(state)
    # (4, 1024, 1024) is the launch of the extract phase; 1216×1600 is one
    # bucket of the Aachen r1600 configuration.
    results["fused_stem"] = {(b, h, w): case(b, h, w) for b, h, w in ((4, 1024, 1024),
                                                                       (1, 1216, 1600))}
    return case


def unit(t):
    return t / t.norm(dim=-1, keepdim=True)


def pair_case(b: int, n1: int, n2: int, c: int, broadcast: bool, seed: int):
    """Matcher inputs [B, N1, C] × [B, N2, C] with about 10 % invalid rows
    and columns. broadcast: one query shared by every bank with batch
    stride 0, as the engine matches a query against its DB banks; else a
    distinct query bank per pair, as DB-pair matching does. Half of each
    bank's rows are noisy copies of its query's rows, so real mutual
    matches exist; the rest are unrelated."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    if broadcast:
        d0 = unit(torch.randn((n1, c), generator=gen, device=dev))[None].expand(b, n1, c)
        v0 = (torch.rand((1, n1), generator=gen, device=dev) > 0.1).expand(b, n1)
    else:
        d0 = unit(torch.randn((b, n1, c), generator=gen, device=dev))
        v0 = torch.rand((b, n1), generator=gen, device=dev) > 0.1
    k = min(n1, n2) // 2
    src = torch.argsort(torch.rand((b, n1), generator=gen, device=dev), dim=1)[:, :k]
    bank = torch.randn((b, n2, c), generator=gen, device=dev)
    bank[:, :k] = d0[torch.arange(b, device=dev)[:, None], src] + 0.3 * unit(bank[:, :k])
    bank = unit(bank)
    v1 = torch.rand((b, n2), generator=gen, device=dev) > 0.1
    desc_bytes = (d0[0] if broadcast else d0).numel() * 4 + bank.numel() * 4
    nbytes = desc_bytes + (v0[0] if broadcast else v0).numel() + v1.numel() + b * n1 * 8
    return d0, bank, v0, v1, nbytes, desc_bytes


def check_matcher(kernel, plain, d0, bank, v0, v1, what: str):
    """Kernel vs plain version in f32 and bf16: ≥ 99.9 % identical matches
    (only near-ties may flip: the plain similarity is a cuBLAS product
    summed in another order), scores within 1e-5, dead rows scoring 0."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        a0, a1 = d0.to(dtype), bank.to(dtype)
        m_k, s_k = kernel(a0, a1, v0, v1)
        m_p, s_p = plain(a0, a1, v0, v1)
        torch.cuda.synchronize()
        agree = (m_k == m_p).float().mean().item()
        alive = s_p != 0
        err = (s_k - s_p)[alive].abs().max().item()
        tag = f"{what} {dtype}"
        require(agree >= 0.999, f"{tag}: matches agree on {agree:.5f} < 0.999 of rows")
        require(err <= 1e-5, f"{tag}: score err {err} > 1e-5")
        require(bool((s_k[~alive] == 0).all()), f"{tag}: dead rows must score 0")
        out[dtype] = (agree, err, int((m_k >= 0).sum().item()))
    return out


def match_case(b: int, n1: int, n2: int, c: int, broadcast: bool) -> dict:
    """K2 against its plain version at one launch shape and layout."""
    d0, bank, v0, v1, nbytes, desc_bytes = pair_case(b, n1, n2, c, broadcast, SEED + 1)
    res = check_matcher(mutual_nn_match_cuda, mutual_nn_match, d0, bank, v0, v1,
                        f"K2 at {[b, n1, n2, c, broadcast]}")

    def library():
        s = torch.bmm(d0, bank.transpose(1, 2))
        rmax, nn12 = s.max(-1)
        return rmax == torch.gather(s.amax(-2), -1, nn12)

    flops = 2 * b * n1 * n2 * c
    (agree, err, n_match), (agree16, err16, _) = res[torch.float32], res[torch.bfloat16]
    row = dict(
        shape=[b, n1, n2, c], broadcast=broadcast, agree=agree, max_abs_err=err,
        bf16_agree=agree16, bf16_max_abs_err=err16, matches=n_match,
        ms=cuda_ms(lambda: mutual_nn_match_cuda(d0, bank, v0, v1)),
        bf16_ms=cuda_ms(lambda: mutual_nn_match_cuda(
            d0.to(torch.bfloat16), bank.to(torch.bfloat16), v0, v1)),
        plain_ms=cuda_ms(lambda: mutual_nn_match(d0, bank, v0, v1)),
        library_ms=cuda_ms(library), gflop=flops / 1e9, mbytes=nbytes / 1e6,
        **matcher_bounds(flops, nbytes, nbytes - desc_bytes / 2),
        # the kernels alone, from a profiler trace (at B ≤ 2 the host's
        # dispatch is a large part of ms and library_ms)
        kernel_device_ms=device_ms_per_call(lambda: mutual_nn_match_cuda(d0, bank, v0, v1)),
        library_device_ms=device_ms_per_call(library))
    emit("kernel_match", **row)
    return row


def tie_check(n: int = 4096, c: int = 128):
    """Exact ties: duplicated query rows 3 and 5 whose common best column in
    bank 0 is 7 must both be granted the match (max-equality contract)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    q = unit(torch.randn((n, c), generator=gen, device=dev))
    q[5] = q[3]
    bank = unit(torch.randn((2, n, c), generator=gen, device=dev))
    bank[0, 7] = q[3]
    ones = torch.ones((2, n), dtype=torch.bool, device=dev)
    m_t, _ = mutual_nn_match_cuda(q[None].expand(2, n, c), bank, ones, ones)
    m_tp, _ = mutual_nn_match(q[None].expand(2, n, c), bank, ones, ones)
    require(m_t[0, 3].item() == 7 and m_t[0, 5].item() == 7, "K2: tie not granted to both rows")
    require(bool((m_t == m_tp).all()), "K2: tie case disagrees with the plain version")
    emit("kernel_match_tie", granted=[m_t[0, 3].item(), m_t[0, 5].item()])


def phase_kernel_match(results):
    # The engine matches the first cluster alone ([1, 4096, 128]), then the
    # remaining candidates or the covisible frames in one bucketed launch
    # (50 frames padded to [64, 4096, 128]), the query broadcast to every
    # bank; map building matches DB pairs in batches of 16 distinct banks.
    # With one bank the two layouts coincide; the wrapper records B=1 as
    # not broadcast.
    # D2-Net's width C=512 below the large-bank threshold also reaches K2.
    results["mutual_nn_match"] = {(*s, bc): match_case(*s, bc) for s, bc in (
        ((64, 4096, 4096, 128), True), ((1, 4096, 4096, 128), False),
        ((16, 4096, 4096, 128), False), ((1, 2048, 2048, 512), False))}
    tie_check()


RATIO = 0.9  # the NNR preset (pipeline/match.py MATCHER_CONFS)


def ratio_case(b: int, n1: int, n2: int, c: int, broadcast: bool) -> dict:
    """K4 against its plain version at one launch shape and layout."""
    d0, bank, v0, v1, nbytes, desc_bytes = pair_case(b, n1, n2, c, broadcast, SEED + 5)
    kernel = lambda a0, a1, x, y: mutual_nn_ratio_match_cuda(a0, a1, RATIO, x, y)  # noqa: E731
    plain = lambda a0, a1, x, y: mutual_nn_ratio_match(a0, a1, RATIO, x, y)  # noqa: E731
    res = check_matcher(kernel, plain, d0, bank, v0, v1, f"K4 at {[b, n1, n2, c, broadcast]}")

    def library():  # the product, the top-2 both ways, the column values at nn12
        s = torch.bmm(d0, bank.transpose(1, 2))
        v12, nn12 = s.topk(2, dim=-1)
        v21, _ = s.topk(2, dim=-2)
        return v12, torch.gather(v21[:, 0], -1, nn12[..., 0]), torch.gather(v21[:, 1], -1, nn12[..., 0])

    flops = 2 * b * n1 * n2 * c
    (agree, err, n_match), (agree16, err16, _) = res[torch.float32], res[torch.bfloat16]
    row = dict(
        shape=[b, n1, n2, c], broadcast=broadcast, ratio=RATIO, agree=agree, max_abs_err=err,
        bf16_agree=agree16, bf16_max_abs_err=err16, matches=n_match,
        ms=cuda_ms(lambda: kernel(d0, bank, v0, v1)),
        bf16_ms=cuda_ms(lambda: kernel(d0.to(torch.bfloat16), bank.to(torch.bfloat16), v0, v1)),
        plain_ms=cuda_ms(lambda: plain(d0, bank, v0, v1)),
        library_ms=cuda_ms(library), gflop=flops / 1e9, mbytes=nbytes / 1e6,
        **matcher_bounds(flops, nbytes, nbytes - desc_bytes / 2),
        kernel_device_ms=device_ms_per_call(lambda: kernel(d0, bank, v0, v1)),
        library_device_ms=device_ms_per_call(library))
    emit("kernel_match_ratio", **row)
    return row


def ratio_tie_check(n: int = 4096, c: int = 128):
    """A column max tied by two rows: query rows 3 and 5 identical, bank 0's
    column 7 a noisy copy of them. The column's multiset top-2 is (s, s),
    its distance ratio ≈ 1 > 0.9, so neither row is matched; with row 5
    changed, row 3 is matched to 7."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    q = unit(torch.randn((n, c), generator=gen, device=dev))
    bank = unit(torch.randn((2, n, c), generator=gen, device=dev))
    bank[0, 7] = unit(q[3] + 0.1 * unit(torch.randn((c,), generator=gen, device=dev)))
    ones = torch.ones((2, n), dtype=torch.bool, device=dev)
    untied, _ = mutual_nn_ratio_match_cuda(q[None].expand(2, n, c), bank, RATIO, ones, ones)
    q[5] = q[3]
    m_t, _ = mutual_nn_ratio_match_cuda(q[None].expand(2, n, c), bank, RATIO, ones, ones)
    m_p, _ = mutual_nn_ratio_match(q[None].expand(2, n, c), bank, RATIO, ones, ones)
    require(untied[0, 3].item() == 7, "K4: the untied row lost its match")
    require(m_t[0, 3].item() == -1 and m_t[0, 5].item() == -1,
            "K4: a tied column max must give c2 == c1 and fail the ratio test")
    require(bool((m_t == m_p).all()), "K4: tie case disagrees with the plain version")
    emit("kernel_match_ratio_tie", untied=untied[0, 3].item(),
         tied=[m_t[0, 3].item(), m_t[0, 5].item()])


def phase_kernel_match_ratio(results):
    # DB-pair matching with the NNR preset: batches of 16 distinct banks;
    # D2-Net's width C=512 below the large-bank threshold.
    results["mutual_nn_ratio_match"] = {
        (16, 4096, 4096, 128, False): ratio_case(16, 4096, 4096, 128, False),
        (1, 2048, 2048, 512, False): ratio_case(1, 2048, 2048, 512, False)}
    ratio_tie_check()


# K5 and K6: (wrapper, plain version, output slots that hold indices,
# bytes written per output row or column).
NN_KERNELS = {"nn_argmax": (nn_argmax_cuda, nn_argmax, (1, 3), 8),
              "nn_top2": (nn_top2_cuda, nn_top2, (1, 4), 12)}


def compare_nn(got, ref, index_slots, what: str):
    """K5/K6 outputs against their plain version's: ≥ 99.9 % identical
    indices (only near-ties may flip: the plain similarity is a cuBLAS
    product summed in another order), values within 1e-5. Returns (lowest
    index agreement, largest value error)."""
    agree, err = 1.0, 0.0
    for k, (g, r) in enumerate(zip(got, ref)):
        if k in index_slots:
            agree = min(agree, (g == r).float().mean().item())
        else:
            err = max(err, (g - r).abs().max().item())
    require(agree >= 0.999, f"{what}: indices agree on {agree:.5f} < 0.999")
    require(err <= 1e-5, f"{what}: value err {err} > 1e-5")
    return agree, err


def nn_case(name: str, b: int, n1: int, n2: int, c: int, broadcast: bool) -> dict:
    """K5 or K6 against its plain version at one launch shape and layout, in
    f32 and bf16, with ~10 % invalid rows and columns."""
    wrapper, plain, index_slots, out_bytes = NN_KERNELS[name]
    d0, bank, v0, v1, _, _ = pair_case(b, n1, n2, c, broadcast, SEED + 8)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        a0, a1 = d0.to(dtype), bank.to(dtype)
        got, ref = wrapper(a0, a1, v0, v1), plain(a0, a1, v0, v1)
        torch.cuda.synchronize()
        what = f"{name} at {[b, n1, n2, c, broadcast]} {dtype}"
        res[dtype] = compare_nn(got, ref, index_slots, what)

    def library():  # the product and its reductions both ways, biases left out
        s = torch.bmm(d0, bank.transpose(1, 2))
        if name == "nn_argmax":
            return s.max(-1), s.max(-2)
        return s.topk(2, dim=-1), s.topk(2, dim=-2)

    flops = 2 * b * n1 * n2 * c
    desc_bytes = 4 * c * (n1 * (1 if broadcast else b) + b * n2)
    nbytes = desc_bytes + n1 * (1 if broadcast else b) + b * n2 \
        + b * (n1 + n2) * out_bytes  # f32 descriptors, bool masks, outputs
    (agree, err), (agree16, err16) = res[torch.float32], res[torch.bfloat16]
    row = dict(
        shape=[b, n1, n2, c], broadcast=broadcast, agree=agree, max_abs_err=err,
        bf16_agree=agree16, bf16_max_abs_err=err16,
        ms=cuda_ms(lambda: wrapper(d0, bank, v0, v1)),
        bf16_ms=cuda_ms(lambda: wrapper(d0.to(torch.bfloat16), bank.to(torch.bfloat16), v0, v1)),
        plain_ms=cuda_ms(lambda: plain(d0, bank, v0, v1)),
        library_ms=cuda_ms(library), gflop=flops / 1e9, mbytes=nbytes / 1e6,
        **matcher_bounds(flops, nbytes, nbytes - desc_bytes / 2),
        # the kernels alone, from a profiler trace (at B = 1 the host's
        # dispatch is a large part of ms and library_ms)
        kernel_device_ms=device_ms_per_call(lambda: wrapper(d0, bank, v0, v1)),
        library_device_ms=device_ms_per_call(library))
    emit(f"kernel_{name}", **row)
    return row


def nn_tie_check(name: str, n: int = 4096, c: int = 128):
    """Exact ties in other tiles and row blocks: query rows 3 and 2000
    identical with bank column 7 their copy (a column tie), bank columns 9
    and 3000 identical with query row 40 their copy (a row tie). The lowest
    index wins both ways, a tied max is also the second value (K6), and the
    kernel equals its plain version there."""
    wrapper, plain, index_slots, _ = NN_KERNELS[name]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    q = unit(torch.randn((2, n, c), generator=gen, device=dev))
    bank = unit(torch.randn((2, n, c), generator=gen, device=dev))
    q[0, 2000] = q[0, 3]
    bank[0, 7] = q[0, 3]
    bank[0, 3000] = bank[0, 9]
    q[0, 40] = bank[0, 9]
    out = wrapper(q, bank)
    ref = plain(q, bank)
    torch.cuda.synchronize()
    nn12, nn21 = out[index_slots[0]], out[index_slots[1]]
    require(nn12[0, 3].item() == 7 and nn12[0, 2000].item() == 7 and nn21[0, 7].item() == 3,
            f"{name}: the column tie did not go to the lowest row")
    require(nn12[0, 40].item() == 9 and nn21[0, 9].item() == 40 and nn21[0, 3000].item() == 40,
            f"{name}: the row tie did not go to the lowest column")
    if name == "nn_top2":
        require(out[2][0, 40].item() == out[0][0, 40].item()
                and out[5][0, 7].item() == out[3][0, 7].item(),
                "nn_top2: a max reached twice must also be the second value")
    compare_nn(out, ref, index_slots, f"{name} tie case")
    tied_rows, tied_cols = [3, 40, 2000], [7, 9, 3000]
    require(torch.equal(nn12[0, tied_rows], ref[index_slots[0]][0, tied_rows])
            and torch.equal(nn21[0, tied_cols], ref[index_slots[1]][0, tied_cols]),
            f"{name}: the plain version resolves the planted ties otherwise")
    emit(f"kernel_{name}_tie", column_tie=[nn12[0, 3].item(), nn12[0, 2000].item(),
                                           nn21[0, 7].item()],
         row_tie=[nn12[0, 40].item(), nn21[0, 9].item(), nn21[0, 3000].item()])


# [1, 4096] is the public op at the JAX package's default 1024-wide tiles;
# 16 distinct banks as DB-pair batches; 8 banks against one broadcast query
# as the engine matches; a ragged shape; D2-Net's width C=512.
NN_SHAPES = [((1, 4096, 4096, 128), False), ((16, 4096, 4096, 128), False),
             ((8, 4096, 4096, 128), True), ((2, 3000, 2500, 128), False),
             ((1, 2048, 2048, 512), False)]


def phase_kernel_nn(results, name: str):
    results[name] = {(*s, bc): nn_case(name, *s, bc) for s, bc in NN_SHAPES}
    nn_tie_check(name)


# The first tiled bank sizes (ops/matching.py::tiled_route): at C=128, and
# at D2-Net's C=512 (models/baselines.py of the JAX package).
LARGE = [(68_992, 128), (19_584, 512)]
SAMPLES = 2048


def large_bank_scene(n: int, c: int, seed: int):
    """A dict-backed store of 3 images × n keypoints × C: image 0 random unit
    descriptors; images 1 and 2 each hold noisy (σ = 0.05 per component,
    renormalised), permuted copies of a random half of image 0's rows, and
    fresh random rows elsewhere. Returns (store, names, to_image) with
    to_image[k][i] the row of image k that copies image 0's row i, or −1."""
    rng = np.random.default_rng(seed)

    def unit_np(a):
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)

    desc = [unit_np(rng.standard_normal((n, c), np.float32))]
    to_image = [np.arange(n)]
    for _ in range(2):
        src = rng.choice(n, n // 2, replace=False)
        pos = rng.permutation(n)
        d = unit_np(rng.standard_normal((n, c), np.float32))
        d[pos[:len(src)]] = unit_np(desc[0][src] + 0.05 * rng.standard_normal((len(src), c),
                                                                              np.float32))
        inv = np.full(n, -1, np.int64)
        inv[src] = pos[:len(src)]
        desc.append(d)
        to_image.append(inv)
    store = FeatureStore()
    names = [f"large/{k}.jpg" for k in range(3)]
    for name, d in zip(names, desc):
        kp = rng.uniform(0, 1600, (n, 2)).astype(np.float32)
        store.write(name, ImageFeatures(kp, d, rng.random(n).astype(np.float32), None))
    return store, names, to_image


def chunked_plain(plain, d0, d1, rows: int = 8192):
    """The plain version of K5/K6 over row stripes of desc0 (the whole
    [N1, N2] similarity does not fit the card): rows concatenated; columns
    merged across stripes in ascending order with the TPU kernel's rule —
    strictly greater takes the argmax, seconds by the multiset rule."""
    n1 = d0.shape[1]
    outs = [plain(d0[:, i: i + rows], d1) for i in range(0, n1, rows)]
    n_row = len(outs[0]) // 2  # row outputs come first, then as many column outputs
    row_part = [torch.cat([o[k] for o in outs], dim=1) for k in range(n_row)]
    col = list(outs[0][n_row:])
    for t, o in enumerate(outs[1:], start=1):
        c1, ca = o[n_row], o[n_row + 1] + t * rows
        take = c1 > col[0]
        if len(col) == 3:
            col[2] = torch.maximum(torch.minimum(col[0], c1), torch.maximum(col[2], o[n_row + 2]))
        col[1] = torch.where(take, ca, col[1])
        col[0] = torch.maximum(col[0], c1)
    return (*row_part, *col)


def sampled_route(mode: str, d0, d1, rows):
    """The large-bank route's matches for `rows` of one pair (all valid),
    from the plain versions alone: the rows' top-2 over every column, the
    top-2 over every row of the columns they picked, the back-pointer and,
    for NNR, the symmetric ratio test."""
    def ratio(a, b):
        dist = lambda v: torch.sqrt(torch.clamp(2.0 - 2.0 * v, min=0.0))  # noqa: E731
        return dist(a) / (dist(b) + 1e-8)

    m1, nn12, m1b, _, _, _ = nn_top2(d0[rows][None], d1[None])
    cols = nn12[0].long()
    _, _, _, c1, nn21, c1b = nn_top2(d0[None], d1[cols][None])
    ok = nn21[0].long() == rows
    if mode == "NNR":
        ok &= (ratio(m1[0], m1b[0]) <= RATIO) & (ratio(c1[0], c1b[0]) <= RATIO)
    return torch.where(ok, nn12[0], -1)


def check_match_large(mode: str, name: str, matches, names, desc, to_image, rows, cols) -> dict:
    """Checks of one ``match_pairs`` run on the large-bank scene, on any
    device: for every pair, the kernel's outputs against the plain version
    on sampled rows (desc0[rows] × desc1) and columns (desc0 × desc1[cols]),
    the written matches against the plain route on the sampled rows, and
    the share of planted true matches recovered (≥ 0.95 for NNM); then pair
    (0, 1) in full against the plain version over row stripes."""
    wrapper, plain, index_slots, _ = NN_KERNELS[name]
    dev = desc[0].device
    agree, err, route_agree, recovered = 1.0, 0.0, 1.0, []
    for a, b in ((0, 1), (0, 2), (1, 2)):
        d0, d1 = desc[a][None], desc[b][None]
        got = wrapper(d0, d1)
        ref_r, ref_c = plain(d0[:, rows], d1), plain(d0, d1[:, cols])
        n_row = len(got) // 2  # row outputs, then column outputs; index at 1 in each
        what = f"match_large {mode} pair {(a, b)}"
        ag_r, er_r = compare_nn([g[:, rows] for g in got[:n_row]], ref_r[:n_row], (1,),
                                what + " rows")
        ag_c, er_c = compare_nn([g[:, cols] for g in got[n_row:]], ref_c[n_row:], (1,),
                                what + " columns")
        m = torch.from_numpy(matches.read(names[a], names[b])[0]).to(dev)
        r_agree = (m[rows] == sampled_route(mode, desc[a], desc[b], rows)).float().mean().item()
        require(r_agree >= 0.999, f"{what}: matches agree with the plain route on "
                                  f"{r_agree:.5f} < 0.999 of sampled rows")
        both = np.nonzero((to_image[a] >= 0) & (to_image[b] >= 0))[0]
        ia = torch.from_numpy(to_image[a][both]).to(dev)
        ib = torch.from_numpy(to_image[b][both]).to(dev)
        recovered.append((m[ia] == ib).float().mean().item())
        agree, err = min(agree, ag_r, ag_c), max(err, er_r, er_c)
        route_agree = min(route_agree, r_agree)
    if mode == "NNM":
        require(min(recovered) >= 0.95, f"match_large NNM: recovered {recovered} < 0.95")
    d0, d1 = desc[0][None], desc[1][None]
    full_agree, full_err = compare_nn(wrapper(d0, d1), chunked_plain(plain, d0, d1),
                                      index_slots, f"match_large {mode} pair (0, 1) in full")
    return dict(recovered=recovered, sampled_agree=agree, sampled_max_abs_err=err,
                route_agree=route_agree, full_pair_agree=full_agree,
                full_pair_max_abs_err=full_err)


def phase_match_large(results):
    """The large-bank route at full width: ``match_pairs`` on 3 images at
    the first tiled bank size of each width in LARGE (68,992 kp at C=128;
    19,584 kp at D2-Net's C=512), one pair per launch (as hloc matches
    pairs), NNM then NNR. Each run is the main path with the counts set to 0
    just before it and read just after; then its checks, a traced rerun
    (which must hold one K5/K6 main kernel per pair: each similarity is
    computed once), and the kernel, its plain version, the library
    yardstick and K2/K4 and their plain versions timed on pair (0, 1)."""
    for n, c in LARGE:
        require(tiled_route(n, c) and not tiled_route(n - 128, c),
                f"match_large: {n} is not the first tiled bank size at C={c}")
        t0 = time.perf_counter()
        store, names, to_image = large_bank_scene(n, c, SEED + 10)
        out = dict(images=[3, n, c], scene_s=round(time.perf_counter() - t0, 3))
        pairs = [(names[0], names[1]), (names[0], names[2]), (names[1], names[2])]
        dev = torch.device("cuda")
        desc = [torch.from_numpy(np.ascontiguousarray(store.read(name).descriptors)).to(dev)
                for name in names]
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        rows = torch.randperm(n, generator=gen, device=dev)[:SAMPLES]
        cols = torch.randperm(n, generator=gen, device=dev)[:SAMPLES]
        key = (1, n, n, c, False)
        d0, d1 = desc[0][None], desc[1][None]
        for mode, name, same_pair, same_pair_plain in (
                ("NNM", "nn_argmax", lambda: mutual_nn_match_cuda(d0, d1),
                 lambda: mutual_nn_match(d0, d1)),
                ("NNR", "nn_top2", lambda: mutual_nn_ratio_match_cuda(d0, d1, RATIO),
                 lambda: mutual_nn_ratio_match(d0, d1, RATIO))):
            wrapper, plain, _, out_bytes = NN_KERNELS[name]
            cfg = MatchConfig(matcher=mode, max_keypoints=n, batch_size=1)
            matches = MatchStore()
            reset_launches()
            t0 = time.perf_counter()
            match_pairs(store, pairs, matches, cfg, device="cuda")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_launches()
            results["main_path"].append(counts)
            launched = {k: sum(v.values()) for k, v in counts.items() if v}
            require(launched == {name: 3}, f"match_large {mode} at {n}: launched {launched}, "
                                           f"expected only {name}, once per pair")
            checks = check_match_large(mode, name, matches, names, desc, to_image, rows, cols)

            def library():  # the product and its reductions both ways, biases left out
                s = torch.bmm(d0, d1.transpose(1, 2))
                if name == "nn_argmax":
                    return s.max(-1), s.max(-2)
                return s.topk(2, dim=-1), s.topk(2, dim=-2)

            flops = 2 * n * n * c
            nbytes = 2 * n * (4 * c + 1) + 2 * n * out_bytes
            b16 = (d0.to(torch.bfloat16), d1.to(torch.bfloat16))
            row = dict(shape=list(key[:4]), broadcast=False,
                       agree=min(checks["sampled_agree"], checks["full_pair_agree"]),
                       max_abs_err=max(checks["sampled_max_abs_err"],
                                       checks["full_pair_max_abs_err"]),
                       ms=cuda_ms(lambda: wrapper(d0, d1), warmup=1, iters=5),
                       bf16_ms=cuda_ms(lambda: wrapper(*b16), warmup=1, iters=5),
                       plain_ms=cuda_ms(lambda: chunked_plain(plain, d0, d1), warmup=1,
                                        iters=3),
                       library_ms=cuda_ms(library, warmup=1, iters=3), gflop=flops / 1e9,
                       mbytes=nbytes / 1e6,
                       **matcher_bounds(flops, nbytes, nbytes - 2 * n * 2 * c),
                       same_pair_k2_k4_ms=cuda_ms(same_pair, warmup=1, iters=5))
            del b16
            torch.cuda.empty_cache()
            # K2's or K4's plain version on the whole pair (a [N, N] f32
            # similarity: 19 GB at 68,992 rows, twice that at K4's peak).
            row["same_pair_k2_k4_plain_ms"] = cuda_ms(same_pair_plain, warmup=1, iters=3)
            torch.cuda.empty_cache()
            results[name][key] = row
            traced = device_profile(lambda: match_pairs(store, pairs, MatchStore(), cfg,
                                                        device="cuda"))
            # The wrapper's count above says 3 calls; the trace says how many
            # main kernels they launched. The profiler can drop a kernel event
            # at the start of a trace (seen on an H100: 2 of 3 launches of one
            # kernel traced), so the trace bounds it from above only: a design
            # with two main kernels per call (the row-stripe K6 launched one
            # kernel twice, the operands swapped) shows more than 3.
            main = sum(k[2] for k in traced["top_kernels"] if "nn_tc_kernel" in k[0])
            require(1 <= main <= 3, f"match_large {mode} at {n}: {main} main kernels in the "
                                    f"traced run of 3 pairs, expected at most one per pair")
            traced["main_kernels_traced"] = main
            out[mode] = dict(match_pairs_s=round(seconds, 3), launches=launched, **checks,
                             kernel=row, profile=traced)
        out["k6_over_k5_ms"] = out["NNR"]["kernel"]["ms"] / out["NNM"]["kernel"]["ms"]
        emit("match_large", **out)
        del store, desc, d0, d1
        torch.cuda.empty_cache()


# The baselines: the registry's networks at full width on the
# ``sfd2-n4096-r1024`` conf's size, with max_keypoints and conf_threshold
# as cli/extract_features.py passes them for that conf; their features
# matched over every pair by K2 (NNM) and K4 (NNR) at 256, 128 and 512 wide.
BASELINE_NETS = ("superpoint", "r2d2", "d2net", "sgd2", "sfd2")
BASELINE_MATCHES = (("superpoint", "NNM", "mutual_nn_match", 256),
                    ("r2d2", "NNM", "mutual_nn_match", 128),
                    ("d2net", "NNR", "mutual_nn_ratio_match", 512),
                    ("superpoint", "NNR", "mutual_nn_ratio_match", 256))
SHIFT = (64, 32)  # (x, y) px between consecutive crops: a multiple of every stride
SHIFT_MARGIN = 64  # px from the edges: beyond every network's reach of the border


def shifted_images(h: int, w: int, seed: int):
    """8 textured images [h, w, 3]: 0–3 crops of one larger texture, image i
    at offset i·SHIFT, so image i+1 is image i moved by −SHIFT; 4–7
    unrelated."""
    big = textured_images(1, h + 3 * SHIFT[1], seed, width=w + 3 * SHIFT[0])[0]
    crops = [np.ascontiguousarray(big[i * SHIFT[1]: i * SHIFT[1] + h,
                                      i * SHIFT[0]: i * SHIFT[0] + w]) for i in range(4)]
    return crops + textured_images(4, h, seed + 1, width=w)


def keypoint_agreement(f_dev, f_cpu) -> dict:
    """Share of identical keypoints (positions to 1/8 px) of two runs, over
    the larger set, and the largest descriptor difference on them."""
    def key(f):
        return {tuple(p): i for i, p in enumerate(np.rint(f.keypoints * 8).astype(int).tolist())}

    kd, kc = key(f_dev), key(f_cpu)
    common = sorted(set(kd) & set(kc))
    err = max((float(np.abs(f_dev.descriptors[kd[p]] - f_cpu.descriptors[kc[p]]).max())
               for p in common), default=0.0)
    return dict(keypoints=len(kc), agree=len(common) / max(len(kd), len(kc), 1),
                desc_max_abs_err=err)


def shift_recovery(f0, f1, matches0, hw) -> dict:
    """The planted shift between images 0 and 1: of image 0's keypoints
    whose shifted position is a keypoint of image 1, both at least
    SHIFT_MARGIN px inside the edges of their images (there each network
    sees the same pixels in both), the share matched to that keypoint."""
    h, w = hw
    at1 = {tuple(p): i for i, p in enumerate(np.rint(f1.keypoints * 2).astype(int).tolist())}

    def inside(p):
        return ((p[:, 0] >= SHIFT_MARGIN) & (p[:, 0] < w - SHIFT_MARGIN)
                & (p[:, 1] >= SHIFT_MARGIN) & (p[:, 1] < h - SHIFT_MARGIN))

    pts = f0.keypoints
    shifted = pts - np.array(SHIFT, np.float32)
    moved = np.rint(shifted * 2).astype(int).tolist()
    pairs = [(i0, at1[tuple(moved[i0])]) for i0 in np.nonzero(inside(pts) & inside(shifted))[0]
             if tuple(moved[i0]) in at1]
    hit = sum(int(matches0[i0] == i1) for i0, i1 in pairs)
    return dict(shift_candidates=len(pairs), shift_recovered=hit,
                shift_share=hit / max(len(pairs), 1))


def timed_per_image(fn, images) -> tuple:
    """fn on each image (or argument tuple) after one warm-up call on the
    first: (outputs, ms per image).
    Each call ends in a fetch to the host, so the host clock holds the
    device's work."""
    fn(images[0])
    out, times = [], []
    for im in images:
        t0 = time.perf_counter()
        out.append(fn(im))
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def peak_mb(device) -> float:
    return torch.cuda.max_memory_allocated() / 2**20 if device.type == "cuda" else 0.0


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def run_baselines(results, device, h: int = 768, w: int = 1024, max_keypoints: int = 4096,
                  small=(192, 256), profile: bool = False) -> dict:
    """The baselines path on `device`: every network of BASELINE_NETS and
    CAPS's descriptor on 8 images of h×w, then match_pairs over the 28
    pairs for each entry of BASELINE_MATCHES. Each network is first held
    against itself on the CPU on one small crop (same seeded weights,
    float32). Every extraction and every matching run is a main path (the
    counts set to 0 before it and read after). `profile`: one traced run of
    each network on image 0 after its timed runs (``device_profile``, under
    ``profiles``). Returns the phase's record; the checks are the
    caller's."""
    dev = torch.device(device)
    cfg = BaselineConfig(max_keypoints=max_keypoints, conf_threshold=0.001)
    images = shifted_images(h, w, SEED + 20)
    names = [f"baseline/{i}.png" for i in range(len(images))]
    crop = np.ascontiguousarray(images[0][: small[0], : small[1]])
    out = dict(images=[len(images), h, w, 3], max_keypoints=max_keypoints, shift=list(SHIFT),
               cpu_check_image=list(small), nets={}, match={}, profiles={})
    feats, stores = {}, {}
    phase_peak = 0.0
    for net in BASELINE_NETS:
        f32 = {"bf16": False} if net == "sfd2" else {}
        f_dev = dynamic_load(net, cfg, device=dev, seed=SEED, **f32)(crop)
        f_cpu = dynamic_load(net, cfg, device="cpu", seed=SEED, **f32)(crop)
        cpu_check = keypoint_agreement(f_dev, f_cpu)
        reset_peak(dev)
        extract = dynamic_load(net, cfg, device=dev, seed=SEED)
        reset_launches()
        feats[net], times = timed_per_image(extract, images)
        counts = read_launches()
        results["main_path"].append(counts)
        if profile:
            out["profiles"][net] = device_profile(lambda: extract(images[0]))
        del extract
        store = stores[net] = FeatureStore()
        for name, f in zip(names, feats[net]):
            store.write(name, ImageFeatures(f.keypoints, f.descriptors, f.scores,
                                            np.array([w, h])))
        norms = np.concatenate([np.linalg.norm(f.descriptors, axis=1) for f in feats[net]])
        out["nets"][net] = dict(
            ms_per_img=float(np.median(times)), ms_per_img_runs=times, peak_mem_mb=peak_mb(dev),
            keypoints_per_image=[len(f.keypoints) for f in feats[net]],
            desc_dim=int(feats[net][0].descriptors.shape[1]),
            finite=bool(all(np.isfinite(f.descriptors).all() and np.isfinite(f.scores).all()
                            and np.isfinite(f.keypoints).all() for f in feats[net])),
            max_unit_norm_err=float(np.abs(norms - 1).max()), cpu_check=cpu_check,
            launches=launches_by_shape(counts))
        phase_peak = max(phase_peak, peak_mb(dev))

    # CAPS: the network on the device at SuperPoint's keypoints (its
    # detector is OpenCV SIFT on the host).
    caps = build_model(CapsResUNet(), device=dev, seed=SEED)
    caps_cpu = build_model(CapsResUNet(), device="cpu", seed=SEED)
    xy_small = dynamic_load("superpoint", cfg, device="cpu", seed=SEED)(crop).keypoints
    d_dev, d_cpu = caps_describe(caps, crop, xy_small), caps_describe(caps_cpu, crop, xy_small)
    del caps_cpu
    reset_peak(dev)
    at_sp = [(im, f.keypoints) for im, f in zip(images, feats["superpoint"])]
    descs, times = timed_per_image(lambda a: caps_describe(caps, *a), at_sp)
    if profile:
        out["profiles"]["caps"] = device_profile(
            lambda: caps_describe(caps, *at_sp[0]))
    out["nets"]["caps"] = dict(
        ms_per_img=float(np.median(times)), ms_per_img_runs=times, peak_mem_mb=peak_mb(dev),
        keypoints_per_image=[len(d) for d in descs], desc_dim=int(descs[0].shape[1]),
        finite=bool(all(np.isfinite(d).all() for d in descs)),
        shapes_ok=all(d.shape == (len(f.keypoints), 256)
                      for d, f in zip(descs, feats["superpoint"])),
        cpu_check=dict(keypoints=len(xy_small),
                       desc_max_abs_err=float(np.abs(d_dev - d_cpu).max()) if len(xy_small)
                       else 0.0))
    phase_peak = max(phase_peak, peak_mb(dev))
    del caps

    pairs = [(names[i], names[j]) for i in range(len(names)) for j in range(i + 1, len(names))]
    for net, mode, kernel, c in BASELINE_MATCHES:
        matches = MatchStore()
        reset_peak(dev)
        reset_launches()
        t0 = time.perf_counter()
        n = match_pairs(stores[net], pairs, matches,
                        MatchConfig(matcher=mode, max_keypoints=max_keypoints), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_launches()
        results["main_path"].append(counts)
        m0, _ = matches.read(names[0], names[1])
        per_pair = [int((matches.read(a, b)[0] >= 0).sum()) for a, b in pairs]
        out["match"][f"{net}_{mode}"] = dict(
            kernel=kernel, desc_dim=c, pairs=n, match_pairs_s=seconds,
            matches_per_pair_mean=float(np.mean(per_pair)), peak_mem_mb=peak_mb(dev),
            launches=launches_by_shape(counts),
            **shift_recovery(feats[net][0], feats[net][1], m0, (h, w)))
        phase_peak = max(phase_peak, peak_mb(dev))
    out["peak_mem_mb"] = phase_peak
    return out


def phase_baselines(results):
    """The baseline extractors on the card (``dynamic_load(..., device=
    "cuda")``, seeded full-width networks), CAPS's ``caps_describe``, and
    their features matched by K2 and K4; each network also on a small crop
    on the CPU with the same weights."""
    out = run_baselines(results, "cuda", profile=True)
    profiles = out.pop("profiles")
    emit("baselines", **out)
    emit("baselines_profile", **profiles)
    for net, rec in out["nets"].items():
        cc = rec["cpu_check"]
        require(rec["finite"] and min(rec["keypoints_per_image"]) > 0,
                f"baselines {net}: non-finite output or an image without keypoints")
        require(rec["desc_dim"] == {"superpoint": 256, "d2net": 512, "caps": 256}.get(net, 128),
                f"baselines {net}: descriptor width {rec['desc_dim']}")
        if net == "caps":
            require(rec["shapes_ok"], "baselines caps: descriptor shape")
        else:
            require(rec["max_unit_norm_err"] <= 1e-4, f"baselines {net}: descriptors not unit")
            require(cc["keypoints"] > 0 and cc["agree"] >= 0.98,
                    f"baselines {net}: {cc['agree']:.4f} of keypoints agree with the CPU")
        require(cc["desc_max_abs_err"] <= 1e-4,
                f"baselines {net}: descriptor err {cc['desc_max_abs_err']} > 1e-4 vs the CPU")
    # Only SFD2 reaches a kernel (K1) among the networks.
    for net in BASELINE_NETS:
        launched = sorted(out["nets"][net]["launches"])
        require(launched == (["fused_stem"] if net == "sfd2" else []),
                f"baselines {net}: kernels launched {launched}")
    for key, rec in out["match"].items():
        launched = rec["launches"]
        require(set(launched) == {rec["kernel"]} and all(
            s[1] == s[2] == out["max_keypoints"] and s[3] == rec["desc_dim"]
            for s in launched[rec["kernel"]]),
            f"baselines {key}: launched {launched}, expected only {rec['kernel']} at "
            f"C={rec['desc_dim']}")
        require(rec["pairs"] == 28, f"baselines {key}: matched {rec['pairs']} pairs")
    sp = out["match"]["superpoint_NNM"]
    require(sp["shift_candidates"] >= 100 and sp["shift_share"] >= 0.95,
            f"baselines: SuperPoint NNM recovered {sp['shift_share']:.4f} of the planted shift "
            f"({sp['shift_candidates']} candidates)")


def run_retrieval(device, h: int = 768, w: int = 1024, n_db: int = 16, n_query: int = 8,
                  small=(192, 256), profile: bool = False) -> dict:
    """DIR retrieval on `device`: ``make_dir`` (ResNet-101, depths
    (3, 4, 23, 3), 2048-D, float32, seeded weights) on n_db textured DB
    images and n_query queries that are noisy copies (σ = 0.01) of DB
    images 0.., then ``pairs_from_retrieval`` (5 per query) and
    ``pca_whiten`` with a PCA fitted on the DB descriptors. The network is
    first held against itself on the CPU on one small crop; `profile`
    traces one image after the timed runs."""
    dev = torch.device(device)
    db = textured_images(n_db, h, SEED + 30, width=w)
    rng = np.random.default_rng(SEED + 31)
    queries = [np.clip(db[i] + rng.normal(0.0, 0.01, db[i].shape), 0, 1).astype(np.float32)
               for i in range(n_query)]
    crop = np.ascontiguousarray(db[0][: small[0], : small[1]])
    g_dev = dynamic_load("dir", device=dev, seed=SEED)(crop)
    g_cpu = dynamic_load("dir", device="cpu", seed=SEED)(crop)
    reset_peak(dev)
    extract = dynamic_load("dir", device=dev, seed=SEED)
    reset_launches()
    descs, times = timed_per_image(extract, db + queries)
    counts = read_launches()
    traced = device_profile(lambda: extract(db[0])) if profile else None
    d_db, d_q = np.stack(descs[:n_db]), np.stack(descs[n_db:])
    db_names = [f"db/{i}.png" for i in range(n_db)]
    q_names = [f"query/{i}.png" for i in range(n_query)]
    pairs = pairs_from_retrieval(q_names, d_q, db_names, d_db, num_matched=5)
    first = {}
    for q, d in pairs:
        first.setdefault(q, d)
    sim = d_q @ d_db.T
    src = sim[np.arange(n_query), np.arange(n_query)]
    others = np.where(np.eye(n_query, n_db, dtype=bool), -np.inf, sim).max(axis=1)
    # dirtorch's PCA power-whitening, the basis fitted on the DB (rank
    # n_db − 1 once centred).
    mean = d_db.mean(axis=0)
    _, sv, vt = np.linalg.svd(d_db - mean, full_matrices=False)
    k = n_db - 1
    white = pca_whiten(d_q, mean, vt[:k], sv[:k] ** 2 / (n_db - 1))
    return dict(
        db_images=[n_db, h, w, 3], queries=n_query, noise_sigma=0.01, depths=[3, 4, 23, 3],
        dim=int(d_db.shape[1]), ms_per_img=float(np.median(times)), ms_per_img_runs=times,
        peak_mem_mb=peak_mb(dev), finite=bool(np.isfinite(d_db).all() and np.isfinite(d_q).all()),
        max_unit_norm_err=float(np.abs(np.linalg.norm(np.concatenate([d_db, d_q]), axis=1)
                                       - 1).max()),
        pairs=len(pairs), first_is_source=[first.get(q) == db_names[i]
                                           for i, q in enumerate(q_names)],
        source_sim=src.tolist(), best_other_sim=others.tolist(),
        pca_dims=k, pca_max_unit_norm_err=float(np.abs(np.linalg.norm(white, axis=1) - 1).max()),
        pca_finite=bool(np.isfinite(white).all()), launches=launches_by_shape(counts),
        cpu_check=dict(desc_max_abs_err=float(np.abs(g_dev - g_cpu).max())), profile=traced)


def phase_retrieval(results):
    out = run_retrieval("cuda", profile=True)
    traced = out.pop("profile")
    emit("retrieval", **out)
    emit("retrieval_profile", **traced)
    require(out["finite"] and out["dim"] == 2048 and out["max_unit_norm_err"] <= 1e-4,
            "retrieval: descriptors must be finite, 2048-D and unit")
    require(out["pairs"] == 5 * out["queries"], f"retrieval: {out['pairs']} pairs")
    require(all(out["first_is_source"]),
            f"retrieval: a query's first pair is not its source: {out['first_is_source']}")
    require(out["pca_finite"] and out["pca_max_unit_norm_err"] <= 1e-6,
            "retrieval: PCA-whitened rows must be finite and unit")
    require(out["cpu_check"]["desc_max_abs_err"] <= 1e-4,
            f"retrieval: descriptor err {out['cpu_check']['desc_max_abs_err']} > 1e-4 vs the CPU")
    require(not out["launches"], f"retrieval: kernels launched {out['launches']}")


# ---------------------------------------------------------------------------
# Training: the shipped configuration, the convergence recipe, and the
# trained checkpoint through K1.
# ---------------------------------------------------------------------------

TRAIN = dict(n_images=20, hw=(768, 1024), crop=512, batch_size=4, iters=5, workers=4)
# 20 images: PairLoader's epoch is one permutation of the dataset, so 5
# batches of 4 need 20 (16 give 4 per epoch).


class SyncTimer:
    """Wall ms per named stage (``timer(name)`` → context manager), the
    device synchronised at both ends, so a stage holds its device work."""

    def __init__(self, device):
        self.sync = device_sync(device)
        self.ms = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name):
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.ms[name].append((time.perf_counter() - t0) * 1e3)

    def wrap(self, fn, name):
        def timed(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)
        return timed


def train_loader(device, teacher_model, timer, n_images, hw, crop, batch_size, iters, workers):
    """PairLoader over seeded textures + the online teacher (its labelling
    timed as ``teacher``)."""
    images = textured_images(n_images, hw[0], SEED + 20, width=hw[1])
    loader = PairLoader(ArrayDataset(images), SyntheticPairBuilder(crop=crop),
                        batch_size=batch_size, seed=SEED, workers=workers, iters_per_epoch=iters)
    teacher = SegTeacher(teacher_model, device=device)
    if timer is not None:
        teacher.label_tensor = timer.wrap(teacher.label_tensor, "teacher")
    return SegTeacherLoader(loader, teacher)


def run_train(device, root, sampler=None, teacher_model=None, profile=False, forms=False,
              **shape) -> dict:
    """The `train` phase on `device`: 2 epochs (timed stage by stage, every
    step logged), a resume and a third epoch (untimed), one injected NaN
    batch, (`profile`) one traced step, and (`forms`) under the key
    "forms" a call that runs the step in each form of ResBlock's grouped
    conv (`train_forms`), left to the caller so that it runs outside the
    main path's launch counts. `shape` overrides TRAIN."""
    shape = {**TRAIN, **shape}
    sampler = sampler or NghSampler2DS()
    teacher_model = teacher_model or seeded_segmentor(seed=SEED)
    timer = SyncTimer(device)
    loader = train_loader(device, teacher_model, timer, **shape)
    tcfg = TrainConfig(sampler=sampler)

    def trainer_cfg(epochs, log_every):
        return TrainerConfig(epochs=epochs, iters_per_epoch=shape["iters"],
                             batch_size=shape["batch_size"], log_every=log_every,
                             save_dir=str(root), run_name="train", train=tcfg)

    trainer = Trainer(loader, trainer_cfg(2, 1), seed=SEED, device=device, timer=timer)
    t0 = time.perf_counter()
    trainer.train()
    device_sync(device)()
    two_epochs_s = time.perf_counter() - t0
    n = 2 * shape["iters"]
    ms = timer.ms
    require(all(len(ms[k]) == n for k in ("loader", "upload", "step", "teacher", "forward",
                                          "backward", "optimizer")),
            f"train: stage counts {({k: len(v) for k, v in ms.items()})}")
    per_step = [ms["loader"][i] + ms["upload"][i] + ms["step"][i] for i in range(n)]
    split = {k: float(np.median(ms[k][1:])) for k in ("teacher", "upload", "forward",
                                                       "backward", "optimizer")}
    split["pairs"] = float(np.median([ms["loader"][i] - ms["teacher"][i] for i in range(1, n)]))
    run = trainer.run_dir
    logged = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]

    # Resume from last.ckpt and train a third epoch, untimed.
    resumed = Trainer(train_loader(device, teacher_model, None, **shape), trainer_cfg(3, 1000),
                      seed=SEED + 1, device=device)
    require(resumed.resume() and resumed.start_epoch == 2, "train: resume from last.ckpt failed")
    t0 = time.perf_counter()
    resumed.train()
    device_sync(device)()
    third_epoch_s = time.perf_counter() - t0
    state = resumed.state
    files = sorted(p.name for p in run.iterdir())

    # One NaN batch: nothing of the state may move.
    batch_np = next(iter(train_loader(device, teacher_model, None, **shape).epoch(99)))
    good = batch_to_device(batch_np, resumed.device)
    bad = good._replace(image1=good.image1.clone())
    bad.image1[0, 0, 0, 0] = float("nan")
    step_fn = resumed._step_for(True)
    before = [t.clone() for t in guarded_state(state)]
    step_before = state.step
    _, nan_metrics = step_fn(state, bad, resumed.step_generator(99, 0))
    nan_unchanged = all(torch.equal(a, b) for a, b in zip(guarded_state(state), before))
    out = dict(
        images=[shape["n_images"], *shape["hw"], 3], crop=shape["crop"],
        batch_size=shape["batch_size"], steps=state.step - 1,
        first_step_ms=per_step[0], median_ms_per_step=float(np.median(per_step[1:])),
        ms_per_step=per_step, steps_per_s=1e3 / float(np.median(per_step[1:])),
        split_median_ms=split, two_epochs_s=two_epochs_s,
        third_epoch_s_untimed=third_epoch_s,
        ms_per_step_untimed=third_epoch_s * 1e3 / shape["iters"],
        logged=[{k: round(v, 6) if isinstance(v, float) else v for k, v in r.items()}
                for r in logged],
        files=files, tb_files=len(list((run / "tb").glob("events.out.tfevents.*"))),
        resumed_at_epoch=2, nan_loss=float(nan_metrics["loss"]),
        nan_state_unchanged=nan_unchanged, nan_step_counted=state.step == step_before + 1,
        run_dir=str(run))
    require(len(logged) == n and all(np.isfinite(v) for r in logged for v in r.values()),
            "train: a logged loss is not finite")
    require(all({"det_loss", "unsup_desc_loss", "seg_det_loss", "seg_desc_loss"} <= set(r)
                for r in logged), "train: a loss term is missing")
    require(state.step - 1 == 3 * shape["iters"], f"train: {state.step - 1} steps after resume")
    require({"last.ckpt", "best.ckpt", "log.txt", "metrics.jsonl", "tb"} <= set(files),
            f"train: run directory holds {files}")
    require(out["tb_files"] >= 2, "train: no TensorBoard events of both runs")
    require("resumed from" in (run / "log.txt").read_text(), "train: log.txt lacks the resume")
    require(not np.isfinite(out["nan_loss"]) and nan_unchanged,
            "train: a NaN batch moved the state")
    if profile:
        out["profile"] = device_profile(
            lambda: step_fn(state, good, resumed.step_generator(99, 1)),
            sum_kernels=("wgrad", "dgrad", "grouped"))
    if forms:
        out["forms"] = functools.partial(train_forms, resumed, good, device, profile=profile)
    return out


def phase_train(results, root) -> str:
    reset_launches()
    out = run_train("cuda", root, profile=True, forms=True)
    counts = read_launches()
    results["main_path"].append(counts)
    traced = out.pop("profile")
    out["conv2_forms"], forms_traced = out.pop("forms")()
    emit("train", **out, launches={k: sum(v.values()) for k, v in counts.items()})
    emit("train_profile", **traced, conv2_forms=forms_traced)
    return out["run_dir"]


# ResBlock's grouped 3×3 conv in its two forms (models/layers.py):
# cuDNN's groups=32 conv and the coarse block-diagonal conv of the JAX
# package. `forward` is the one the port runs; `train` and `extract` time
# both, in turns.
FORMS = ("grouped", "coarse")
CONV_GROUPS = 32
CONV_CHECK = (4, 256, 128, 128)  # compared in f32 at stride 1 and 2
CONV_TRAIN = (8, 256, 128, 128)  # the train step's ResBlocks: 8 crops of 512²
CONV_EXTRACT = (4, 256, 256, 256)  # extract r1024's ResBlocks: 4 images of 1024², bf16


# The train step also runs cuDNN's groups=32 conv with its weight gradient
# on the channels-last activations as they come (the port's earlier path).
TRAIN_FORMS = FORMS + ("grouped_in_layout",)


def conv2_form(form: str):
    """Context: ResBlock's grouped conv in `form`."""
    stack = contextlib.ExitStack()
    if form == "coarse":
        stack.enter_context(patched(GroupedConvAsDense, "forward", GroupedConvAsDense.coarse))
    if form == "grouped_in_layout":
        stack.enter_context(patched(GroupedConvAsDense, "forward", torch.nn.Conv2d.forward))
    return stack


def form_order(rounds: int, forms=FORMS) -> list:
    """grouped, coarse, then coarse, grouped, …: each form in turn."""
    return [f for r in range(rounds) for f in (forms if r % 2 == 0 else forms[::-1])]


def conv_flops(shape, stride: int, groups: int) -> float:
    """Multiply-adds × 2 of a 3×3 conv over C channels in `groups` groups."""
    b, c, h, w = shape
    return 2.0 * b * -(-h // stride) * -(-w // stride) * c * (c // groups) * 9


def conv_forms_case(shape, stride: int, dtype, grads: bool, channels_last: bool = False,
                    device="cuda") -> dict:
    """One GroupedConvAsDense on the card, seeded, its input NCHW or (as the
    model's trunk gets it) channels-last: both forms' outputs (and with
    `grads` the weight and input gradients of a seeded upstream gradient)
    compared, and each form's ms in turns (the forward as the caller runs
    it: under no_grad, or with `grads` building the autograd graph; and
    with `grads` forward + backward). With `grads` and `channels_last`,
    `grouped_in_layout` times cuDNN's groups=32 conv on the channels-last
    input as it comes (the port's earlier training path)."""
    gen = torch.Generator().manual_seed(SEED + stride)
    conv = GroupedConvAsDense(shape[1], CONV_GROUPS, stride)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                          * conv.weight[0].numel() ** -0.5)
    conv = conv.to(device, dtype)
    layout = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.randn(shape, generator=gen).to(device, dtype).contiguous(memory_format=layout)
    run = {"grouped": conv, "coarse": conv.coarse}
    if grads and channels_last:
        run["grouped_in_layout"] = functools.partial(torch.nn.Conv2d.forward, conv)
    with torch.no_grad():
        outs = {form: fn(x) for form, fn in run.items()}
    up = torch.randn(outs["grouped"].shape, generator=gen).to(device, dtype)
    up = up.contiguous(memory_format=layout)
    ref = outs["grouped"].float()
    out = dict(shape=list(shape), stride=stride, dtype=str(dtype).split(".")[-1],
               channels_last=channels_last, coarse_groups=conv.coarse_groups,
               out_rel_err=float((outs["coarse"].float() - ref).abs().max() / ref.abs().max()))
    xg = x.clone().requires_grad_(grads)
    if grads:
        wg, xgrad = {}, {}
        for form in FORMS:
            conv.weight.grad, xg.grad = None, None
            run[form](xg).backward(up)
            wg[form], xgrad[form] = conv.weight.grad.float(), xg.grad.float()
        for name, g in (("wgrad", wg), ("dgrad", xgrad)):
            out[f"{name}_err_of_max"] = float((g["coarse"] - g["grouped"]).abs().max()
                                              / g["grouped"].abs().max())
    flops = {f: conv_flops(shape, stride, conv.coarse_groups if f == "coarse" else CONV_GROUPS)
             for f in run}
    fwd, fwd_bwd = {f: [] for f in run}, {f: [] for f in run}
    for form in form_order(2, tuple(run)):
        fn = run[form]
        with torch.set_grad_enabled(grads):
            fwd[form].append(cuda_ms(lambda: fn(xg)))
        if grads:
            fwd_bwd[form].append(cuda_ms(lambda: fn(xg).backward(up)))
    out["forms"] = {f: dict(gflop_fwd=flops[f] / 1e9, fwd_ms=fwd[f],
                            fwd_tflops=flops[f] / 1e9 / float(np.median(fwd[f])),
                            **(dict(fwd_bwd_ms=fwd_bwd[f]) if grads else {}))
                    for f in run}
    return out


def phase_grouped_conv(results):
    """ResBlock's grouped conv: the coarse form against cuDNN's groups=32
    conv on the card in f32 (outputs within 1e-5 relative, weight gradients
    within 1e-4 of their largest magnitude), and both forms timed at the
    train step's and extraction's shapes, channels-last as the trunk's
    activations are."""
    checks = [conv_forms_case(CONV_CHECK, stride, torch.float32, grads=True)
              for stride in (1, 2)]
    for c in checks:
        require(c["out_rel_err"] <= 1e-5 and c["wgrad_err_of_max"] <= 1e-4
                and c["dgrad_err_of_max"] <= 1e-4,
                f"grouped_conv: the coarse form differs from the grouped conv {c}")
    train = conv_forms_case(CONV_TRAIN, 1, torch.float32, grads=True, channels_last=True)
    extract = conv_forms_case(CONV_EXTRACT, 1, torch.bfloat16, grads=False, channels_last=True)
    require(extract["out_rel_err"] <= 1e-2,
            f"grouped_conv: bf16 coarse form differs {extract['out_rel_err']}")
    emit("grouped_conv", checks=checks, train_shape=train, extract_shape=extract)


def train_forms(trainer, batch, device, steps: int = 4, rounds: int = 2,
                profile: bool = False) -> tuple:
    """The train step (`trainer`'s state and loss, one device batch) in
    each of TRAIN_FORMS, in turns: per round one warm-up step and `steps`
    timed ones; the median ms of the step (its forward, backward and
    optimizer stages) and of each stage, and (`profile`) one traced step
    per form with the conv kernels' device ms."""
    ms = {f: collections.defaultdict(list) for f in TRAIN_FORMS}
    traced = {}
    for form in form_order(rounds, TRAIN_FORMS):
        timer = SyncTimer(device)
        step = make_train_step(trainer.state.model, trainer.superpoint, trainer.cfg.train,
                               timer=timer)
        with conv2_form(form):
            for i in range(steps + 1):
                trainer.state, metrics = step(trainer.state, batch, trainer.step_generator(98, i))
                require(bool(torch.isfinite(metrics["loss"])), f"train: {form} form's loss")
            if profile and form not in traced:
                plain = make_train_step(trainer.state.model, trainer.superpoint,
                                        trainer.cfg.train)
                traced[form] = device_profile(
                    lambda: plain(trainer.state, batch, trainer.step_generator(98, 99)),
                    sum_kernels=("wgrad", "dgrad", "grouped"))
        for k in ("forward", "backward", "optimizer"):
            ms[form][k] += timer.ms[k][1:]
    summary = {}
    for f in TRAIN_FORMS:
        per_step = [sum(v) for v in zip(*(ms[f][k] for k in ("forward", "backward", "optimizer")))]
        summary[f] = dict(ms_per_step=float(np.median(per_step)), ms_per_step_runs=per_step,
                          **{f"{k}_ms": float(np.median(v)) for k, v in ms[f].items()})
    return summary, traced


def extract_forms(ex, images, rounds: int = 2, iters: int = 3) -> tuple:
    """`ex.extract_batch(images)` in each form of ResBlock's grouped conv,
    in turns: ms/img of `iters` batches after one warm-up batch per round,
    and one traced batch per form."""
    times, traced = {f: [] for f in FORMS}, {}
    for form in form_order(rounds):
        with conv2_form(form):
            ex.extract_batch(images)
            for _ in range(iters):
                t0 = time.perf_counter()
                ex.extract_batch(images)
                times[form].append((time.perf_counter() - t0) * 1e3 / len(images))
            if form not in traced:
                p = device_profile(lambda: ex.extract_batch(images), sum_kernels=("grouped",))
                traced[form] = {k: p[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                                  "top_kernels", "kernel_ms_containing")}
    return {f: dict(ms_per_img=float(np.median(v)), runs=v) for f, v in times.items()}, traced


CONVERGE_SAMPLER = dict(ngh=3, subq=-4, pos_d=1, neg_d=2, border=3, subd_neg=-4)
CONVERGE_SEED = 7  # the student's seeded init (SuperPoint's: + 1), pinned on a CPU run


def shifted_pair_batch(rng, r=48, shift=4):
    """tests/test_convergence.py's pair: image 2 is image 1 moved by
    `shift` px, aflow the truth (NaN outside the overlap), two label halves."""
    base = rng.normal(size=(r + shift, r + shift, 3)).astype(np.float32)
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, -1, 0) + np.roll(base, -1, 1)) / 5
    img1 = base[:r, :r]
    img2 = base[shift: shift + r, shift: shift + r]
    ys, xs = np.mgrid[0:r, 0:r]
    aflow = np.stack([xs - shift, ys - shift], -1).astype(np.float32)[None]
    aflow[(aflow < 0).any(-1)] = np.nan
    seg = np.zeros((1, r, r), np.int32)
    seg[:, : r // 2] = 2
    seg[:, r // 2:] = 13
    return dict(image1=img1[None], image2=img2[None], gray1=img1.mean(-1, keepdims=True)[None],
                gray2=img2.mean(-1, keepdims=True)[None], aflow=aflow, seg1=seg), img1


def converge_models(seed=CONVERGE_SEED):
    model = seeded_init_(ResSegNetV2(require_stability=True, require_feature=True), seed)
    return model, seeded_init_(SuperPoint(), seed + 1)


def converge_cfg():
    return TrainConfig(lr=3e-4, loss=SegLossConfig(topk_per_half=32),
                       sampler=NghSampler2DS(**CONVERGE_SAMPLER))


def np_batch_on(batch_np, device, dtype=torch.float32):
    return TrainBatch(**{k: torch.from_numpy(v).to(device, dtype if v.dtype == np.float32
                                                    else torch.int64)
                         for k, v in batch_np.items()})


def run_train_converge(device, steps: int = 200, seed: int = CONVERGE_SEED) -> dict:
    """tests/test_convergence.py's recipe through the port: `steps` Adam
    steps (lr 3e-4) on one 48² shifted pair from the seeded init; the bars
    are the JAX test's."""
    batch_np, img1 = shifted_pair_batch(np.random.default_rng(3))
    model, sp = converge_models(seed)
    model, sp = model.to(device), sp.to(device)
    cfg = converge_cfg()
    state = TrainState(model=model, optimizer=make_optimizer(cfg, model))
    step = make_train_step(model, sp, cfg)
    batch = np_batch_on(batch_np, device)
    with torch.no_grad():
        gt = sp(batch.gray1)["scores"][0].cpu().numpy()

    def det_corr():
        model.eval()
        with torch.no_grad():
            score = model(torch.from_numpy(img1[None]).to(device)).score[0].cpu().numpy()
        return float(np.corrcoef(score.ravel(), gt.ravel())[0, 1])

    corr_init = det_corr()
    losses = []
    t0 = time.perf_counter()
    sampler = cfg.sampler
    for i in range(steps):
        # Positions from a CPU generator: the card and the CPU rehearsal
        # draw the same ones.
        pos = sampler.sample_positions(torch.Generator().manual_seed(i), 1, 12, 12)
        state, metrics = step(state, batch, None, pos)
        losses.append(metrics["loss"])
    losses = [float(v) for v in losses]
    seconds = time.perf_counter() - t0
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    corr_after = det_corr()
    return dict(steps=state.step, seconds=seconds, ms_per_step=seconds * 1e3 / steps,
                first10=first, last10=last, ratio=last / first, corr_init=corr_init,
                corr_after=corr_after, corr_gain=corr_after - corr_init,
                finite=bool(np.all(np.isfinite(losses))))


def step_grads(device, positions, dtype=torch.float32, group=None):
    """One train step of the converge setting from the seeded init on
    `device` with the given sampler positions: (losses, gradients); with a
    process `group`, the data-parallel step (synchronised BatchNorm)."""
    batch_np, _ = shifted_pair_batch(np.random.default_rng(3))
    model, sp = converge_models()
    model, sp = model.to(device, dtype), sp.to(device, dtype)
    if group is not None:
        convert_sync_batchnorm(model, group)
    cfg = converge_cfg()
    state = TrainState(model=model, optimizer=make_optimizer(cfg, model))
    _, metrics = make_train_step(model, sp, cfg, group=group)(
        state, np_batch_on(batch_np, device, dtype), None, positions)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().double().cpu().numpy() for n, p in model.named_parameters()})


def grad_gap(a, b, ref) -> dict:
    """Per tensor max |a − b| over max |ref|, `ref` the float64 gradient;
    tensors without one (a bias before a train-mode BatchNorm) are left
    out."""
    gaps = {n: float(np.abs(a[n] - b[n]).max() / np.abs(ref[n]).max())
            for n in ref if np.abs(ref[n]).max() > 1e-6}
    worst = max(gaps, key=gaps.get)
    return dict(max=gaps[worst], worst=worst, median=float(np.median(list(gaps.values()))),
                under_1e3=sum(v <= 1e-3 for v in gaps.values()), tensors=len(gaps))


def check_step_card_cpu(device="cuda") -> dict:
    """The same train step (weights, batch, sampler positions) on `device`
    twice, on the CPU in float32 and in float64."""
    positions = NghSampler2DS(**CONVERGE_SAMPLER).sample_positions(
        torch.Generator().manual_seed(SEED), 1, 12, 12)
    m_dev, g_dev = step_grads(device, positions)
    m_dev2, g_dev2 = step_grads(device, positions)
    m_cpu, g_cpu = step_grads("cpu", positions)
    m_64, g_64 = step_grads("cpu", positions, torch.float64)
    loss_rel = max(abs(m_dev[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu)
    return dict(loss_max_rel_err=loss_rel, grad_card_vs_cpu=grad_gap(g_dev, g_cpu, g_64),
                grad_card_rerun=grad_gap(g_dev, g_dev2, g_64),
                grad_cpu32_vs_cpu64=grad_gap(g_cpu, g_64, g_64),
                grad_card_vs_cpu64=grad_gap(g_dev, g_64, g_64),
                losses_card=m_dev, losses_cpu=m_cpu)


def check_adam_schedule(device="cuda") -> dict:
    """Adam with a decaying rate, capturable on the card (its count and the
    rate on the device) against the CPU's: three steps on fixed gradients."""
    cfg = TrainConfig(lr=1e-2, decay_rate=0.5, decay_iter=1)
    out = []
    for dev in (device, "cpu"):
        gen = torch.Generator().manual_seed(SEED)
        module = torch.nn.Module()
        for name, shape in (("weight", (4, 8)), ("bias", (4,))):
            module.register_parameter(name, torch.nn.Parameter(
                torch.randn(shape, generator=gen).to(dev)))
        grads = [torch.randn(p.shape, generator=gen).to(dev) for p in module.parameters()]
        opt = make_optimizer(cfg, module)
        for _ in range(3):
            for p, g in zip(module.parameters(), grads):
                p.grad = g.clone()
            set_lr(cfg, opt)
            opt.step()
        out.append([p.detach().cpu() for p in module.parameters()])
    return dict(adam_max_abs_err=max(float((a - b).abs().max()) for a, b in zip(*out)))


def phase_train_converge(results):
    reset_launches()
    out = run_train_converge("cuda")
    results["main_path"].append(read_launches())
    out.update(check_step_card_cpu(), **check_adam_schedule())
    emit("train_converge", **out)
    require(out["finite"] and out["steps"] == 200, "train_converge: non-finite losses")
    require(out["ratio"] < 0.92, f"train_converge: loss ratio {out['ratio']} ≥ 0.92")
    require(out["corr_gain"] > 0.06, f"train_converge: correlation gain {out['corr_gain']}")
    require(out["loss_max_rel_err"] <= 1e-4,
            f"train_converge: card and CPU losses differ by {out['loss_max_rel_err']}")
    require(out["grad_card_vs_cpu"]["max"] <= 1e-3,
            f"train_converge: card and CPU gradients differ by {out['grad_card_vs_cpu']}")
    require(out["adam_max_abs_err"] <= 1e-6, "train_converge: capturable Adam differs")


def run_train_extract(device, run_dir) -> tuple:
    """K1 on the trained weights: last.ckpt through extract_features'
    loader, Extractor at sfd2-n4096-r1024 in float32 on 4 images of 1024²,
    against the same extraction with the model's own unfused stem (eval
    mode, the running statistics the trainer wrote). (result, launches)."""
    state = load_model_state(Path(run_dir) / "last.ckpt")
    conf = dataclasses.replace(EXTRACTION_CONFS["sfd2-n4096-r1024"], bf16=False)
    images = textured_images(4, 1024, SEED + 30)
    ex = Extractor(state, conf, device=device)
    ex.extract_batch(images)  # warm-up
    reset_launches()
    t0 = time.perf_counter()
    feats = ex.extract_batch(images)
    ms = (time.perf_counter() - t0) * 1e3 / len(images)
    counts = read_launches()
    model = ex.model

    def unfused_stem(x, stem, dtype):
        out = model.bn1b(model.conv1b(model.conv1a(x.permute(0, 3, 1, 2))))
        return out.permute(0, 2, 3, 1).to(dtype)

    with patched(pipeline_extract, "fused_stem_cuda", unfused_stem):
        ref = ex.extract_batch(images)
    agree = []
    for f, r in zip(feats, ref):
        a = keypoint_agreement(f, r)
        kf = {tuple(p): i for i, p in enumerate(np.rint(f.keypoints * 8).astype(int).tolist())}
        kr = {tuple(p): i for i, p in enumerate(np.rint(r.keypoints * 8).astype(int).tolist())}
        a["score_max_abs_err"] = max((abs(float(f.scores[kf[p]] - r.scores[kr[p]]))
                                      for p in set(kf) & set(kr)), default=0.0)
        agree.append(a)
    return dict(images=[4, 1024, 1024, 3], ms_per_img=ms,
                fused_stem_launches=sum(counts["fused_stem"].values()),
                stem_shapes=[[*k, v] for k, v in counts["fused_stem"].items()],
                num_batches_tracked=int(state["conv1a.1.num_batches_tracked"]),
                agreement=agree), counts


def phase_train_extract(results, run_dir):
    out, counts = run_train_extract("cuda", run_dir)
    results["main_path"].append(counts)
    emit("train_extract", **out)
    require(out["fused_stem_launches"] > 0, "train_extract: K1 was not launched")
    require(out["num_batches_tracked"] > 0, "train_extract: untrained statistics")
    for a in out["agreement"]:
        require(a["keypoints"] > 0 and a["agree"] >= 0.98,
                f"train_extract: {a['agree']:.4f} of keypoints agree with the unfused stem")
        require(a["desc_max_abs_err"] <= 1e-4 and a["score_max_abs_err"] <= 1e-4,
                f"train_extract: descriptors/scores differ by {a}")


# ---------------------------------------------------------------------------
# Training's data sources and the mesh (slice 11)
# ---------------------------------------------------------------------------

SOURCES = dict(n_db=4, n_debug=4, hw=(768, 1024), crop=512, batch_size=4, iters=2, epochs=3,
               workers=4)
# A known homography: point p of the first image of a flow pair lands at
# FLOW_H · p in the second, which is the first warped by it.
FLOW_H = np.array([[1.02, 0.03, -12.0], [-0.02, 0.99, 8.0], [1e-5, -2e-5, 1.0]])


def write_jpeg(path: Path, img: np.ndarray):
    """A float RGB image as a JPEG, whatever the file's extension (the
    Aachen style-transfer stills are named ``<tag>.jpg.st_*``)."""
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    bgr = np.clip(np.rint(img[..., ::-1] * 255.0), 0, 255).astype(np.uint8)
    path.write_bytes(cv2.imencode(".jpg", bgr)[1].tobytes())


def write_sources(root: Path, n_db: int, n_debug: int, hw, seed: int) -> dict:
    """An Aachen layout (db images, style-transfer stills, optical-flow
    pairs from FLOW_H) and a debug folder of PNGs under `root`; the flow
    PNGs read back beside the flow written (``flow_png``)."""
    h, w = hw
    aachen = root / "aachen"
    db = aachen / "images_upright" / "db"
    images = textured_images(n_db + n_debug, h, seed, width=w)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    p = np.stack([xs, ys, np.ones_like(xs)], -1) @ FLOW_H.T
    target = p[..., :2] / p[..., 2:]
    flow = (target - np.stack([xs, ys], -1)).astype(np.float32)
    mask = (target[..., 0] >= 0) & (target[..., 0] < w) & (target[..., 1] >= 0) & \
        (target[..., 1] < h)
    flow_err, stored = 0.0, True
    for i in range(n_db):
        img = images[i]
        if i % 2:  # the second of a flow pair: the first warped by FLOW_H
            img = warp_perspective(images[i - 1], FLOW_H, (w, h))
        write_jpeg(db / f"{1000 + i}.jpg", img)
        if i % 2 == 0:
            write_jpeg(aachen / "style_transfer" / f"{1000 + i}.jpg.st_0",
                       np.clip(0.8 * img + 0.1, 0.0, 1.0))
        else:
            name = f"{1000 + i - 1}_{1000 + i}.png"
            for sub in ("flow", "mask"):
                (aachen / "optical_flow" / sub).mkdir(parents=True, exist_ok=True)
            q = flow_to_png(flow, aachen / "optical_flow" / "flow" / name)
            write_png(aachen / "optical_flow" / "mask" / name, mask.astype(np.uint8) * 255)
            back = png_to_flow(aachen / "optical_flow" / "flow" / name)
            stored &= bool(np.array_equal(back, q))
            flow_err = max(flow_err, float(np.abs(back - flow).max()))
    (root / "debug").mkdir(parents=True, exist_ok=True)
    for i in range(n_debug):
        write_png(root / "debug" / f"{i:03d}.png",
                  np.clip(np.rint(images[n_db + i] * 255.0), 0, 255).astype(np.uint8))
    return dict(aachen=aachen, debug=root / "debug",
                flow_png=dict(max_abs_err_px=flow_err, decoded_equals_stored=stored,
                              valid_share=float(mask.mean())))


def source_names(dataset, root: Path) -> list:
    """The img1 path (relative to `root`) of every pair of
    ``build_data_source("DSF")``: the debug images, then the db image of
    each style-transfer still, then the first db image of each flow pair."""
    debug, still, flows = dataset.datasets
    names = list(debug.base.paths)
    names += [still.base.paths[i] for i, _ in still.pairs]
    names += [flows.db._base / flows.db.imgs[a] for a, _, _ in flows.pairs]
    return [str(Path(p).relative_to(root)) for p in names]


def run_train_sources(device, root: Path, teacher_model=None, seg_mode: str = "slide",
                      **shape) -> dict:
    """The `train_sources` phase on `device`: write the sources, label every
    image with the seeded ConvNeXt-B UPerNet (``cli/segment_images.py``'s
    `segment_folder`), then train from ``build_data_source("DSF")`` with the
    labels (``LabelDirPairs``), every step logged and timed by stage.
    `shape` overrides SOURCES."""
    shape = {**SOURCES, **shape}
    data = root / "data"
    src = write_sources(data, shape["n_db"], shape["n_debug"], shape["hw"], SEED + 40)
    seg = Segmentor(teacher_model or seeded_segmentor(seed=SEED), SegmentorConfig(mode=seg_mode),
                    device=device)
    sync = device_sync(device)
    t0 = time.perf_counter()
    n_labelled = sum(segment_folder(seg, data / sub, root / "labels" / sub)
                     for sub in ("aachen/images_upright", "debug"))
    sync()
    label_s = time.perf_counter() - t0
    crop = shape["crop"]
    ds = build_data_source("DSF", crop=crop, aachen_root=src["aachen"], debug_root=src["debug"],
                           seed=SEED)
    pairs = LabelDirPairs(ds, LabelDirTeacher(root / "labels"), source_names(ds, data))
    loader = PairLoader(pairs, PrecomputedPairBuilder(crop=crop), batch_size=shape["batch_size"],
                        seed=SEED, workers=shape["workers"], iters_per_epoch=shape["iters"])
    timer = SyncTimer(device)
    cfg = TrainerConfig(epochs=shape["epochs"], iters_per_epoch=shape["iters"],
                        batch_size=shape["batch_size"], log_every=1, save_dir=str(root),
                        run_name="sources", train=TrainConfig())
    trainer = Trainer(loader, cfg, seed=SEED, device=device, timer=timer)
    t0 = time.perf_counter()
    trainer.train()
    sync()
    train_s = time.perf_counter() - t0
    n = shape["epochs"] * shape["iters"]
    ms = timer.ms
    per_step = [ms["loader"][i] + ms["upload"][i] + ms["step"][i] for i in range(n)]
    logged = [json.loads(line) for line in
              (trainer.run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in logged]
    batch = next(iter(loader.epoch(0)))
    return dict(
        pairs=len(ds), sources={"D": len(ds.datasets[0]), "S": len(ds.datasets[1]),
                                "F": len(ds.datasets[2])},
        image_hw=list(shape["hw"]), crop=crop, batch_size=shape["batch_size"], steps=n,
        labelled_images=n_labelled, label_s=label_s, label_ms_per_img=label_s * 1e3 / n_labelled,
        seg_mode=seg_mode, flow_png=src["flow_png"], train_s=train_s,
        first_step_ms=per_step[0], median_ms_per_step=float(np.median(per_step[1:])),
        split_median_ms={k: float(np.median(ms[k][1:])) for k in
                         ("loader", "upload", "forward", "backward", "optimizer")},
        losses=losses, first_loss=losses[0], last_loss=losses[-1],
        loss_terms=sorted(logged[0]), seg1_in_batches="seg1" in batch,
        seg1_labelled_share=float((batch["seg1"] > 0).mean()) if "seg1" in batch else 0.0)


def phase_train_sources(results, root: Path):
    reset_launches()
    out = run_train_sources("cuda", root)
    results["main_path"].append(read_launches())
    emit("train_sources", **out)
    fp = out["flow_png"]
    require(fp["decoded_equals_stored"] and fp["max_abs_err_px"] <= 1 / 32 + 1e-5,
            f"train_sources: the flow PNG reads back {fp}")
    require(out["labelled_images"] == SOURCES["n_db"] + SOURCES["n_debug"],
            f"train_sources: {out['labelled_images']} images labelled")
    require(out["seg1_in_batches"] and out["seg1_labelled_share"] > 0.9,
            "train_sources: the batches carry no labels")
    require({"seg_det_loss", "seg_desc_loss"} <= set(out["loss_terms"]),
            f"train_sources: loss terms {out['loss_terms']}")
    require(all(np.isfinite(out["losses"])), "train_sources: a loss is not finite")
    k = SOURCES["iters"]
    require(np.mean(out["losses"][-k:]) < np.mean(out["losses"][:k]),
            f"train_sources: losses do not fall {out['losses']}")


MESH_BANK = (64, 4096, 128)  # the localize phase's query against its banks
MESH_PAIRS = (16, 4096, 128)  # a map build's pair batch


def timed_ms(fn, rtt: float) -> float:
    """ms per call by ``utils/benchtime.py``'s paired windows, fenced by a
    CUDA event."""
    return timed_per_item(fn, cuda_fence, iters=3, inner=4, rtt=rtt) * 1e3


def mesh_cases():
    """The localize query against [64,4096,128] banks with labels, and a
    [16,4096,128] pair batch."""
    b, n, c = MESH_BANK
    d0, bank, v0, v1, _, _ = pair_case(b, n, n, c, True, SEED + 50)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    l0 = torch.randint(0, 4, (n,), generator=gen, device="cuda")
    l1 = torch.randint(0, 4, (b, n), generator=gen, device="cuda")
    b, n, c = MESH_PAIRS
    pairs = pair_case(b, n, n, c, False, SEED + 52)[:4]
    return (d0, bank, v0, v1, l0, l1), pairs


def unsharded_nnr(d0, d1, v0, v1):
    return mutual_nn_ratio_match_cuda(d0, d1, RATIO, v0, v1)


def drive_mesh_matching(meshes: dict, bank_case, pairs) -> dict:
    """Each mesh's sharded matchers once: the query against the split bank
    (labels off: K2; on: the plain label-aware matcher) and the pair batch
    split for NNM (K2) and NNR (K4)."""
    d0, bank, v0, v1, l0, l1 = bank_case
    got = {}
    for name, mesh in meshes.items():
        got[f"bank_{name}"] = query_vs_sharded_bank(mesh, d0[0], bank, v0[0], v1)
        got[f"bank_labels_{name}"] = query_vs_sharded_bank(mesh, d0[0], bank, v0[0], v1, l0, l1)
        for mode in ("nnm", "nnr"):
            got[f"pairs_{mode}_{name}"] = make_sharded_pair_matcher(mesh, mode, RATIO)(*pairs)
    return got


def check_mesh_matching(meshes: dict, bank_case, pairs, got: dict, rtt: float) -> dict:
    """Each sharded result against the unsharded K2/K4 call (bit-identical
    matches and scores), and the time of both."""
    d0, bank, v0, v1, l0, l1 = bank_case
    b, n = bank.shape[:2]
    refs = {"bank": mutual_nn_match_cuda(d0, bank, v0, v1),
            "bank_labels": mutual_nn_match_with_labels(d0, bank, l0[None].expand(b, n), l1, v0, v1),
            "pairs_nnm": mutual_nn_match_cuda(*pairs), "pairs_nnr": unsharded_nnr(*pairs)}
    out = {key: dict(identical=all(torch.equal(a, r)
                                   for a, r in zip(res, refs[key.rsplit("_", 1)[0]])),
                     matches=int((res[0] >= 0).sum())) for key, res in got.items()}
    for name, mesh in meshes.items():
        out[f"bank_{name}"]["ms"] = timed_ms(
            lambda m=mesh: query_vs_sharded_bank(m, d0[0], bank, v0[0], v1), rtt)
        for mode in ("nnm", "nnr"):
            out[f"pairs_{mode}_{name}"]["ms"] = timed_ms(
                lambda f=make_sharded_pair_matcher(mesh, mode, RATIO): f(*pairs), rtt)
    out["bank_unsharded_ms"] = timed_ms(lambda: mutual_nn_match_cuda(d0, bank, v0, v1), rtt)
    out["pairs_nnm_unsharded_ms"] = timed_ms(lambda: mutual_nn_match_cuda(*pairs), rtt)
    out["pairs_nnr_unsharded_ms"] = timed_ms(lambda: unsharded_nnr(*pairs), rtt)
    return out


def check_mesh_localize(engines: dict, plain, jobs, got: dict, seq, rtt: float) -> dict:
    """``localize`` over each mesh against the localize phase's sequential
    pass (bit-identical poses), and ms per query over each mesh and
    without one (`plain`, its banks uploaded by a first pass)."""
    def ms(eng):
        return timed_per_item(lambda: [eng.localize(*job) for job in jobs], cuda_fence,
                              items_per_call=len(jobs), iters=2, inner=1, rtt=rtt) * 1e3

    [plain.localize(*job) for job in jobs]
    out = {name: dict(identical_to_localize=same_results(got[name], seq), ms_per_query=ms(eng))
           for name, eng in engines.items()}
    out["unsharded_ms_per_query"] = ms(plain)
    return out


def check_mesh_extraction(state, conf, extractors: dict, images, got: dict, rtt: float) -> dict:
    """``Extractor`` over each mesh at [4,1024,1024] (bf16 trunk, as the
    extract phase): each device's share bit for bit what one device gives
    on that share alone, the keypoints beside the unsplit batch's, and ms
    per image over each mesh and without one."""
    def ms(ex):
        return timed_per_item(lambda: ex.extract_batch(images), cuda_fence,
                              items_per_call=len(images), iters=3, inner=1, rtt=rtt) * 1e3

    plain = Extractor(state, conf, device="cuda")
    whole = plain.extract_batch(images)
    out = {}
    for name, ex in extractors.items():
        share = len(images) // ex.mesh.shape["data"]
        alone = [f for i in range(0, len(images), share)
                 for f in plain.extract_batch(images[i:i + share])]
        out[name] = dict(
            ms_per_img=ms(ex),
            shares_identical=all(all(np.array_equal(x, y) for x, y in zip(a, b))
                                 for a, b in zip(got[name], alone)),
            keypoints_identical_to_unsplit=[keypoint_agreement(a, b)["agree"]
                                            for a, b in zip(got[name], whole)],
            keypoints=[int(len(f.keypoints)) for f in got[name]])
    out["unsharded_ms_per_img"] = ms(plain)
    return out


def data_parallel_step(device="cuda") -> dict:
    """One synchronised train step at world size 1 over ``nccl`` (the
    converge setting: full-width ResSegNetV2 at 48²) against the plain step
    on the card and the CPU's float64 step."""
    positions = NghSampler2DS(**CONVERGE_SAMPLER).sample_positions(
        torch.Generator().manual_seed(SEED), 1, 12, 12)
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(0, 1, Path(tmp) / "rendezvous", device=device)
        try:
            backend = str(dist.get_backend())
            m_dp, g_dp = step_grads(device, positions, group=dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    m_dev, g_dev = step_grads(device, positions)
    _, g_64 = step_grads("cpu", positions, torch.float64)
    return dict(backend=backend, world_size=1,
                loss_max_rel_err=max(abs(m_dp[k] - m_dev[k]) / max(abs(m_dev[k]), 1e-12)
                                     for k in m_dev),
                grad_vs_plain=grad_gap(g_dp, g_dev, g_64), grad_vs_cpu64=grad_gap(g_dp, g_64, g_64),
                losses=m_dp)


def phase_mesh(results, state, store, scene, seq):
    """Meshes of the real devices (``make_mesh()``) and of four entries of
    cuda:0: sharded matching (K2, K4), the engine's ``localize`` with a mesh
    beside the sequential pass of ``localize``, ``Extractor`` over the mesh
    (K1), and one data-parallel train step. The launch counts hold one run
    of each mesh path; the references, timings and warm-ups run outside."""
    meshes = {"devices": make_mesh(), "cuda0x4": make_mesh(devices=["cuda:0"] * 4)}
    rtt = measure_rtt()
    t0 = time.perf_counter()
    bank_case, pairs = mesh_cases()
    jobs = [(qname, scene.qinfo, [[j] for j in near]) for qname, _, _, near in scene.queries]
    config = LocalizerConfig(**LOCALIZE_CONFIG)
    engines = {name: LocalizationEngine(scene.map_index, store, config, device="cuda", mesh=mesh)
               for name, mesh in meshes.items()}
    for eng in engines.values():  # uploads the banks and captures the graphs, as `localize`
        [eng.localize(*job) for job in jobs]
    conf = EXTRACTION_CONFS["sfd2-n4096-r1024"]
    images = textured_images(4, 1024, SEED + 4)
    extractors = {name: Extractor(state, conf, device="cuda", mesh=mesh)
                  for name, mesh in meshes.items()}
    reset_launches()
    got_match = drive_mesh_matching(meshes, bank_case, pairs)
    got_loc = {name: [eng.localize(*job) for job in jobs] for name, eng in engines.items()}
    got_ext = {name: ex.extract_batch(images) for name, ex in extractors.items()}
    counts = read_launches()
    results["main_path"].append(counts)
    matching = check_mesh_matching(meshes, bank_case, pairs, got_match, rtt)
    localize = check_mesh_localize(
        engines, LocalizationEngine(scene.map_index, store, config, device="cuda"), jobs,
        got_loc, seq, rtt)
    extraction = check_mesh_extraction(state, conf, extractors, images, got_ext, rtt)
    dp = data_parallel_step()
    emit("mesh", meshes={k: [str(d) for d in m.devices.ravel()] for k, m in meshes.items()},
         rtt_ms=rtt * 1e3, seconds=time.perf_counter() - t0, matching=matching,
         localize=localize, extraction=extraction, data_parallel=dp,
         launches={k: sum(v.values()) for k, v in counts.items()},
         launch_shapes=launches_by_shape(counts))
    for key, row in matching.items():
        if isinstance(row, dict):
            require(row["identical"] and row["matches"] > 0,
                    f"mesh: {key} differs from the unsharded call {row}")
    for name in meshes:
        require(localize[name]["identical_to_localize"], f"mesh: localize over {name} differs")
        row = extraction[name]
        require(row["shares_identical"], f"mesh: extraction over {name} differs per share")
        require(min(row["keypoints_identical_to_unsplit"]) >= 0.99,
                f"mesh: extraction over {name} keeps {row['keypoints_identical_to_unsplit']}")
    require(counts["fused_stem"] and counts["mutual_nn_match"] and counts["mutual_nn_ratio_match"],
            "mesh: K1, K2 and K4 must all run")
    require(dp["backend"] == "nccl" and dp["loss_max_rel_err"] <= 1e-4
            and dp["grad_vs_plain"]["max"] <= 1e-3 and dp["grad_vs_cpu64"]["max"] <= 1e-3,
            f"mesh: the data-parallel step differs {dp}")


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def gather_case(n: int, m: int, c: int, sorted_idx: bool = False) -> dict:
    """K3 against its plain version: table [N, C], idx [M] (random, or
    sorted as BA's point gathers are); a gather does no arithmetic, so the
    result must be exact."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    table = torch.randn((n, c), generator=gen, device=dev)
    idx = torch.randint(0, n, (m,), generator=gen, device=dev, dtype=torch.int32)
    if sorted_idx:
        idx = torch.sort(idx).values
    got = gather_rows_cuda(table, idx)
    ref = gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item() if m else 0.0
    require(err == 0.0 and bool(torch.equal(got, ref)), f"K3 at {[n, m, c, sorted_idx]}: err {err}")
    nbytes = (n * c + m + m * c) * 4
    bound_ms, bound_by = bound(0, nbytes)
    # ms: CUDA events around one call, host dispatch included (a
    # microsecond kernel waits on it; median of 50, the host's time per
    # call varies); graph_ms: one launch inside a CUDA
    # graph of 100 (as bundle adjustment replays it); *_device_ms: the
    # kernels alone, from a profiler trace (null where the trace held no
    # kernel event).
    row = dict(shape=[n, m, c], sorted_idx=sorted_idx, max_abs_err=err,
               ms=cuda_ms(lambda: gather_rows_cuda(table, idx), iters=50),
               graph_ms=graph_ms(lambda: gather_rows_cuda(table, idx)),
               plain_ms=cuda_ms(lambda: gather_rows_plain(table, idx), iters=50),
               library_ms=cuda_ms(lambda: table.index_select(0, idx), iters=50),
               kernel_device_ms=device_ms_per_call(lambda: gather_rows_cuda(table, idx)),
               library_device_ms=device_ms_per_call(lambda: table.index_select(0, idx)),
               mbytes=nbytes / 1e6, bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel_gather", **row)
    return row


def phase_kernel_gather(results):
    # Bundle adjustment's gathers at map scale (~1.4e5 observations of 60
    # cameras and 14000 points): rotations (C=9), translations and point
    # updates (3), intrinsics (8), the fixed-camera mask (1), camera updates
    # (6) by unsorted camera index; points (3) by sorted point index.
    shapes = [(60, 140_000, 9, False), (60, 140_000, 3, False), (60, 140_000, 8, False),
              (60, 140_000, 1, False), (60, 140_000, 6, False), (14_000, 140_000, 3, True)]
    results["gather_rows"] = {s[:3]: gather_case(*s) for s in shapes}


def textured_images(n: int, size: int, seed: int, width: int | None = None):
    """Seeded synthetic textures [size, width (= size), 3]: blocky colour
    noise at three scales."""
    rng = np.random.default_rng(seed)
    width = width or size
    out = []
    for _ in range(n):
        img = np.zeros((size, width, 3), np.float32)
        for cell, wgt in ((64, 0.5), (16, 0.3), (4, 0.2)):
            base = rng.random((-(-size // cell), -(-width // cell), 3)).astype(np.float32)
            img += wgt * np.kron(base, np.ones((cell, cell, 1), np.float32))[:size, :width]
        out.append(np.clip(img, 0.0, 1.0))
    return out


def phase_extract(results, state):
    # Reference on a small input: the same Extractor in float32 on the card
    # and on the CPU (plain versions, float32 trunk) must find the same
    # keypoints; ≥ 98 % identical keypoints (convolution sums run in another
    # order, which flips near-tied NMS/top-K decisions) and descriptors
    # within 1e-3 on those (float32 through ~20 conv layers).
    small = textured_images(1, 256, SEED + 3)
    conf = ExtractionConfig(max_keypoints=512, resize_max=1024, bf16=False)
    f_gpu = Extractor(state, conf, device="cuda").extract_batch(small)[0]
    f_cpu = Extractor(state, conf, device="cpu").extract_batch(small)[0]
    key = lambda f: {tuple(p): i for i, p in enumerate(np.rint(f.keypoints).astype(int))}
    kg, kc = key(f_gpu), key(f_cpu)
    common = sorted(set(kg) & set(kc))
    frac = len(common) / max(len(kc), 1)
    derr = max((np.abs(f_gpu.descriptors[kg[p]] - f_cpu.descriptors[kc[p]]).max()
                for p in common), default=0.0)
    require(len(kc) > 0 and frac >= 0.98, f"extract: {frac:.4f} of keypoints agree with CPU")
    require(derr <= 1e-3, f"extract: descriptor err {derr} > 1e-3 vs CPU")

    ex = Extractor(state, EXTRACTION_CONFS["sfd2-n4096-r1024"], device="cuda")
    images = textured_images(4, 1024, SEED + 4)
    ex.extract_batch(images)  # warm-up: cuDNN algorithm selection, kernel load
    reset_launches()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        feats = ex.extract_batch(images)
        times.append((time.perf_counter() - t0) * 1e3 / len(images))
    results["main_path"].append(read_launches())
    n_kp = [int(len(f.keypoints)) for f in feats]
    for f in feats:
        require(np.isfinite(f.keypoints).all() and np.isfinite(f.descriptors).all(),
                "extract: non-finite output")
        require(f.descriptors.shape == (len(f.keypoints), 128), "extract: descriptor shape")
    require(min(n_kp) > 0, "extract: an image produced no keypoints")
    require(fused_stem_cuda.launches > 0, "extract: the stem kernel was not launched")
    stem_launches = fused_stem_cuda.launches
    stem_shapes = [[*k, v] for k, v in fused_stem_cuda.shapes.items()]
    forms, forms_traced = extract_forms(ex, images)
    emit("extract", images=[4, 1024, 1024, 3], keypoints_per_image=n_kp,
         ms_per_img=float(np.median(times)), ms_per_img_runs=times, conv2_forms=forms,
         stem_launches=stem_launches, stem_shapes=stem_shapes,
         cpu_check=dict(keypoints=len(kc), agree=frac, desc_max_abs_err=float(derr)))
    emit("extract_profile", **device_profile(lambda: ex.extract_batch(images)),
         conv2_forms=forms_traced)


def label_maps_for(images, seed: int):
    """Seeded semantic id maps: three labelled rectangles (ids 1..200) on
    about 2.5 % of each image, 0 elsewhere, so that both blocks of the
    labelled-first top-K hold keypoints."""
    rng = np.random.default_rng(seed)
    out = []
    for im in images:
        h, w = im.shape[:2]
        lab = np.zeros((h, w), np.int32)
        for _ in range(3):
            y, x = rng.integers(0, h * 9 // 10), rng.integers(0, w * 11 // 12)
            lab[y: y + h // 10, x: x + w // 12] = rng.integers(1, 201)
        out.append(lab)
    return out


def labelled_first(f) -> bool:
    """No unlabelled keypoint ranks above a labelled one."""
    lab = f.labels > 0
    return not np.any(~lab[:-1] & lab[1:])


def phase_extract_r1600_ms(results, state):
    """Multi-scale, labelled r1600 extraction (conf ``sfd2-n4096-r1600-ms``:
    scales 1, 0.8333, 0.6944) of four 1600×1200 images with label maps,
    the full-width ResSegNetV2: K1 at [4,1216,1600,3], [4,1024,1344,3] and
    [4,896,1152,3]. Reference on a small input: the same multi-scale,
    labelled configuration in float32 on the card and on the CPU must find
    the same keypoints (≥ 98 %, as ``extract``) with equal labels."""
    conf = dataclasses.replace(EXTRACTION_CONFS["sfd2-n4096-r1600-ms"], max_keypoints=512,
                               bf16=False)
    small = textured_images(2, 240, SEED + 5, width=320)
    small_lab = label_maps_for(small, SEED + 5)
    f_gpu = Extractor(state, conf, device="cuda").extract_batch(small, small_lab)
    f_cpu = Extractor(state, conf, device="cpu").extract_batch(small, small_lab)
    agree, n_ref = 0, 0
    for fg, fc in zip(f_gpu, f_cpu):
        kg = {tuple(p): i for i, p in enumerate(np.rint(fg.keypoints * 8).astype(int))}
        kc = {tuple(p): i for i, p in enumerate(np.rint(fc.keypoints * 8).astype(int))}
        common = set(kg) & set(kc)
        agree, n_ref = agree + len(common), n_ref + len(kc)
        require(all(fg.labels[kg[p]] == fc.labels[kc[p]] for p in common),
                "extract_r1600_ms: labels differ from the CPU's")
    frac = agree / max(n_ref, 1)
    require(n_ref > 0 and frac >= 0.98, f"extract_r1600_ms: {frac:.4f} of keypoints agree with CPU")

    ex = Extractor(state, EXTRACTION_CONFS["sfd2-n4096-r1600-ms"], device="cuda")
    images = textured_images(4, 1200, SEED + 6, width=1600)
    labels = label_maps_for(images, SEED + 6)
    ex.extract_batch(images, labels)  # warm-up: cuDNN algorithm selection per scale
    reset_launches()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        feats = ex.extract_batch(images, labels)
        times.append((time.perf_counter() - t0) * 1e3 / len(images))
    counts = read_launches()
    results["main_path"].append(counts)
    for f in feats:
        require(np.isfinite(f.keypoints).all() and np.isfinite(f.descriptors).all(),
                "extract_r1600_ms: non-finite output")
        require(f.descriptors.shape == (len(f.keypoints), 128) and 0 < len(f.keypoints) <= 4096,
                "extract_r1600_ms: keypoint or descriptor shape")
        require(f.labels is not None and (f.labels > 0).any() and (f.labels == 0).any(),
                "extract_r1600_ms: labelled and unlabelled keypoints must both be kept")
        require(labelled_first(f),
                "extract_r1600_ms: an unlabelled keypoint ranks above a labelled one")
    stem = counts["fused_stem"]
    want = {(4, 1216, 1600), (4, 1024, 1344), (4, 896, 1152)}
    require(want <= set(stem), f"extract_r1600_ms: stem shapes {sorted(stem)} lack {sorted(want)}")
    emit("extract_r1600_ms", images=[4, 1200, 1600, 3], scales=list(ex.cfg.scales),
         keypoints_per_image=[len(f.keypoints) for f in feats],
         labelled_per_image=[int((f.labels > 0).sum()) for f in feats],
         ms_per_img=float(np.median(times)), ms_per_img_runs=times,
         stem_shapes=[[*k, v] for k, v in stem.items()],
         cpu_check=dict(keypoints=n_ref, agree=frac))
    emit("extract_r1600_ms_profile",
         **device_profile(lambda: ex.extract_batch(images, labels)))


LOCALIZE_CONFIG = dict(max_keypoints=4096, pnp_pad_floor=4096)


def pose_recall(results, queries) -> tuple:
    """(recall@(0.25 m, 2°), recall@(0.5 m, 5°), rotation errors, translation
    errors) of results against the queries' ground truth."""
    errs = np.array([pose_error(r.qvec, r.tvec, q_gt, t_gt)
                     for r, (_, q_gt, t_gt, _) in zip(results, queries)])
    q_err, t_err = errs[:, 0], errs[:, 1]
    return (float(np.mean((t_err < 0.25) & (q_err < 2.0))),
            float(np.mean((t_err < 0.5) & (q_err < 5.0))), q_err, t_err)


def same_results(a, b) -> bool:
    """Bit-identical poses, counts and sources."""
    return all(np.array_equal(x.qvec, y.qvec) and np.array_equal(x.tvec, y.tvec)
               and x.num_inliers == y.num_inliers and x.source == y.source for x, y in zip(a, b))


def phase_localize(results):
    """The query path on the corridor scene: a first sequential pass, then
    the timed one (it replays the first pass's graphs and must capture
    none), then ``localize_many`` and ``localize_throughput`` on the same
    queries, as ``bench.py:846-883`` scores them. Each path's launches are
    read on their own."""
    store = FeatureStore()
    t0 = time.perf_counter()
    scene = build_corridor_scene(store, n_images=60, n_queries=8, n_points=14000,
                                 kp_per_image=4096, kp_per_query=4096, desc_dim=128,
                                 retrieval_k=50, seed=7)
    build_s = time.perf_counter() - t0
    eng = LocalizationEngine(scene.map_index, store, LocalizerConfig(**LOCALIZE_CONFIG),
                             device="cuda")
    jobs = [(qname, scene.qinfo, [[j] for j in near]) for qname, _, _, near in scene.queries]
    # A first pass uploads the banks and captures the graphs of every padded
    # size these queries reach (query 0 the most, a later query's refinement
    # may reach a larger correspondence bucket); the timed second pass
    # replays them and must capture nothing.
    graphs.stats.update(captures=0, replays=0, capture_s=0.0)
    first_ms, first = [], []
    for job in jobs:
        t1 = time.perf_counter()
        first.append(eng.localize(*job))
        first_ms.append((time.perf_counter() - t1) * 1e3)
    first_graphs = dict(graphs.stats)
    reset_launches()
    per_q, seq = [], []
    for job in jobs:
        t1 = time.perf_counter()
        seq.append(eng.localize(*job))
        per_q.append(time.perf_counter() - t1)
    seq_counts = read_launches()
    results["main_path"].append(seq_counts)
    seq_graphs = {k: graphs.stats[k] - first_graphs[k] for k in first_graphs}
    r1, r2, q_err, t_err = pose_recall(seq, scene.queries)

    reset_launches()
    t0 = time.perf_counter()
    par = eng.localize_many(jobs, workers=4)
    wall_p = time.perf_counter() - t0
    par_counts = read_launches()
    results["main_path"].append(par_counts)

    eng.localize_throughput(jobs)  # warm: captures the graphs of the batched shapes
    captures_warm = graphs.stats["captures"]
    reset_launches()
    bstats: dict = {}
    t0 = time.perf_counter()
    bat = eng.localize_throughput(jobs, stats=bstats)
    wall_b = time.perf_counter() - t0
    bat_counts = read_launches()
    results["main_path"].append(bat_counts)
    rb, _, _, _ = pose_recall(bat, scene.queries)
    acc = sum(v for k, v in bstats.items() if k.endswith("_s"))
    seq_qps = 1.0 / float(np.median(per_q))

    emit("localize", scene_build_s=build_s, e2e_query_ms=float(np.median(per_q)) * 1e3,
         per_query_ms=[x * 1e3 for x in per_q], recall_025m_2deg=r1, recall_05m_5deg=r2,
         med_terr_m=float(np.median(t_err)), med_rerr_deg=float(np.median(q_err)),
         sources=[r.source for r in seq], match_launches=sum(seq_counts["mutual_nn_match"].values()),
         match_shapes=[[*k, v] for k, v in seq_counts["mutual_nn_match"].items()],
         first_pass_ms=first_ms, first_pass_graph_captures=first_graphs["captures"],
         first_pass_capture_s=first_graphs["capture_s"], graph_captures=seq_graphs["captures"],
         graph_replays=seq_graphs["replays"],
         e2e_qps_sequential=seq_qps, e2e_qps_pipelined=len(jobs) / wall_p,
         e2e_qps_batched=len(jobs) / wall_b,
         e2e_pipeline_speedup=max(len(jobs) / wall_p, len(jobs) / wall_b) / seq_qps,
         e2e_accept_batched=f"{sum(r.source == 'accepted' for r in bat)}/{len(jobs)}",
         e2e_recall_batched=rb,
         e2e_batched_breakdown={**{k[:-2] + "_ms": v * 1e3 for k, v in sorted(bstats.items())
                                   if k.endswith("_s")},
                                "match_fetch_mb": bstats.get("match_fetch_mb", 0.0),
                                "other_ms": (wall_b - acc) * 1e3},
         batched_sources=[r.source for r in bat],
         pipelined_match_shapes=[[*k, v] for k, v in par_counts["mutual_nn_match"].items()],
         batched_match_shapes=[[*k, v] for k, v in bat_counts["mutual_nn_match"].items()],
         graph_captures_total=graphs.stats["captures"], graph_replays_total=graphs.stats["replays"])
    require(r1 >= 0.875, f"localize: recall@(0.25m, 2deg) {r1} < 0.875")
    require(rb >= 0.875, f"localize_throughput: recall@(0.25m, 2deg) {rb} < 0.875")
    require(seq_graphs["captures"] == 0,
            "localize: the timed queries captured graphs anew instead of replaying them")
    require(seq_graphs["replays"] > 0, "localize: no CUDA graph was replayed")
    require(same_results(first, seq), "localize: the second pass differs from the first")
    require(same_results(seq, par), "localize_many: results differ from the sequential loop")
    require(graphs.stats["captures"] == captures_warm,
            "localize_throughput: the timed run captured graphs anew")
    for name, counts in (("localize", seq_counts), ("localize_many", par_counts),
                         ("localize_throughput", bat_counts)):
        require(sum(counts["mutual_nn_match"].values()) > 0,
                f"{name}: the matcher kernel was not launched")
    profile_query(eng, scene)
    phase_pnp_graph(eng, jobs)
    return store, scene, seq


def phase_pnp_graph(eng, jobs):
    """One batch of the throughput path's PnP-RANSAC inputs and one of its
    refinement inputs, recorded from a ``localize_throughput`` run: each
    program replayed from its CUDA graphs against the same program run
    eagerly on the card (identical inliers, counts and sources of
    success, poses within 1e-5), with the seconds of both."""
    recorded, real = [], graphs.run

    def recording(program):
        recorded.append(program)
        return real(program)

    graphs.run = recording
    try:
        eng.localize_throughput(jobs)
    finally:
        graphs.run = real
    out = {}
    for kind, n_flags in (("pnp", 9), ("refine", 8)):
        prog = next(p for p in recorded if p.name[0] == kind)
        got, ref = real(prog), graphs.run_eager(prog)
        torch.cuda.synchronize()
        pose_err = (got[:, :7] - ref[:, :7]).abs().max().item()
        same = torch.equal(got[:, 7:n_flags], ref[:, 7:n_flags]) and \
            torch.equal(got[:, n_flags:], ref[:, n_flags:])
        secs = {}
        for how, fn in (("graph", real), ("eager", graphs.run_eager)):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(prog)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            secs[how] = float(np.median(times)) * 1e3
        out[kind] = dict(key=str(graphs.program_key(prog)), queries=int(got.shape[0]),
                         segments=["graph" if c else "eager" for c, _ in prog.segments],
                         pose_max_abs_diff=pose_err, identical_counts_and_masks=same,
                         graph_ms=secs["graph"], eager_ms=secs["eager"])
        require(same, f"pnp_graph: {kind} counts or inlier masks differ between graph and eager")
        require(pose_err <= 1e-5, f"pnp_graph: {kind} poses differ by {pose_err} > 1e-5")
    emit("pnp_graph", **out)


def phase_serve(results, store, scene, seq):
    """``LocalizationService`` on the localize scene, warmed up, behind
    ``make_server`` in a thread: /healthz, then the 8 queries POSTed from 4
    client threads; every answer 200 and equal to ``engine.localize``'s,
    and at least two requests in flight at once."""
    service = LocalizationService(scene.map_index, store, LocalizerConfig(**LOCALIZE_CONFIG),
                                  device="cuda")
    warm_s = service.warmup()
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://{server.server_address[0]}:{server.server_address[1]}"
    in_flight, peak, gate = [0], [0], threading.Lock()
    real = service.engine.localize

    def counted(*args):
        with gate:
            in_flight[0] += 1
            peak[0] = max(peak[0], in_flight[0])
        try:
            return real(*args)
        finally:
            with gate:
                in_flight[0] -= 1

    def post(i):
        qname, _, _, near = scene.queries[i]
        body = {"query_name": qname, "db_ids": [int(j) for j in near],
                "camera": {"model": scene.cam_model, "width": scene.width,
                           "height": scene.height, "params": list(scene.cam_params)}}
        req = urllib.request.Request(f"{url}/localize", json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read()), (time.perf_counter() - t0) * 1e3

    service.engine.localize = counted
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        captures = graphs.stats["captures"]
        reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=4) as pool:
            replies = list(pool.map(post, range(len(scene.queries))))
        wall = time.perf_counter() - t0
        counts = read_launches()
        results["main_path"].append(counts)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    equal = all(code == 200 and res["qvec"] == [float(v) for v in ref.qvec]
                and res["tvec"] == [float(v) for v in ref.tvec]
                and res["num_inliers"] == ref.num_inliers and res["source"] == ref.source
                for (code, res, _), ref in zip(replies, seq))
    emit("serve", warmup_s=warm_s, healthz=health, statuses=[c for c, _, _ in replies],
         request_ms=[res["ms"] for _, res, _ in replies], client_ms=[ms for _, _, ms in replies],
         wall_s=wall, qps=len(replies) / wall, peak_in_flight=peak[0], equal_to_engine=equal,
         graph_captures=graphs.stats["captures"] - captures,
         match_launches=sum(counts["mutual_nn_match"].values()))
    require(health.get("ok") and health.get("images") == len(scene.map_index.images),
            f"serve: /healthz answered {health}")
    require(all(c == 200 for c, _, _ in replies), "serve: a request did not answer 200")
    require(equal, "serve: answers differ from engine.localize's")
    require(peak[0] >= 2, f"serve: requests never overlapped (peak {peak[0]})")
    require(graphs.stats["captures"] == captures, "serve: requests captured graphs anew")
    require(sum(counts["mutual_nn_match"].values()) > 0, "serve: the matcher kernel was not launched")


def phase_localizer(results, store, scene, seq):
    """The localizer front end on the corridor scene: the map written with
    ``write_model`` and read back, the query list, retrieval pairs and
    ground truth as text files, the dict-backed store; ``localize_queries``
    then ``write_results``. Recall from ``geometry/pose.py`` ≥ 0.875 at
    (0.25 m, 2°) and poses bit-identical to ``engine.localize``'s on the
    same queries (the localize phase's timed pass); then one query again
    under ``utils/profiling.trace``, which must write its trace file."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        mi = scene.map_index
        write_model(mi.cameras, mi.images, mi.points3d, tmp / "sfm")
        cam = " ".join([scene.cam_model, str(scene.width), str(scene.height),
                        *map(str, scene.cam_params)])
        (tmp / "queries.txt").write_text("".join(f"{q} {cam}\n" for q, _, _, _ in scene.queries))
        (tmp / "retrieval.txt").write_text("".join(
            f"{q} {mi.images[j].name}\n" for q, _, _, near in scene.queries for j in near))
        (tmp / "gt.txt").write_text("".join(
            f"{q.split('/')[-1]} " + " ".join(map(str, [*qv, *tv])) + "\n"
            for q, qv, tv, _ in scene.queries))
        queries = parse_image_lists_with_intrinsics(tmp / "queries.txt")
        retrievals = parse_retrieval(tmp / "retrieval.txt")
        gt = load_gt_poses(tmp / "gt.txt")
        map_index = MapIndex(*read_model(tmp / "sfm"))
        run_cfg = LocalizerRun(dataset="aachen_v1.1", init_type="sng",
                               config=LocalizerConfig(**LOCALIZE_CONFIG))
        engine = LocalizationEngine(map_index, store, run_cfg.config, device="cuda")
        localize_queries(queries, retrievals, map_index, store, run_cfg, gt, engine=engine)
        reset_launches()
        t0 = time.perf_counter()
        poses, failed, stats, log = localize_queries(queries, retrievals, map_index, store,
                                                     run_cfg, gt, engine=engine)
        wall = time.perf_counter() - t0
        counts = read_launches()
        results["main_path"].append(counts)
        write_results(poses, failed, log, tmp / "out" / "poses.txt", "aachen_v1.1")
        lines = (tmp / "out" / "poses.txt").read_text().splitlines()

        est = [poses[q] for q, _ in queries]
        ref = [gt[q.split("/")[-1]] for q, _ in queries]
        q_err, t_err = pose_error_tensors(
            *(torch.tensor(np.array(a), dtype=torch.float64) for a in
              ([p[0] for p in est], [p[1] for p in est], [r["qvec"] for r in ref],
               [r["tvec"] for r in ref])))
        recall = recall_at_thresholds(q_err, t_err).tolist()
        identical = all(np.array_equal(p[0], r.qvec) and np.array_equal(p[1], r.tvec)
                        for p, r in zip(est, seq))

        t0 = time.perf_counter()
        with trace(tmp / "trace", "cuda"):
            localize_queries(queries[:1], retrievals, map_index, store, run_cfg, gt,
                             engine=engine)
        trace_s = time.perf_counter() - t0
        trace_files = sorted(p.name for p in (tmp / "trace").iterdir())
        trace_mb = sum(p.stat().st_size for p in (tmp / "trace").iterdir()) / 2**20
    emit("localizer", queries=len(queries), wall_s=wall, ms_per_query=wall * 1e3 / len(queries),
         recall=recall, stats_recall=stats["recall"], failed=failed, poses_lines=len(lines),
         identical_to_engine=identical, match_launches=sum(counts["mutual_nn_match"].values()),
         match_shapes=[[*k, v] for k, v in counts["mutual_nn_match"].items()],
         traced_queries=1, trace_s=trace_s, trace_files=trace_files, trace_mb=trace_mb)
    require(recall[0] >= 0.875, f"localizer: recall@(0.25m, 2deg) {recall[0]} < 0.875")
    require(abs(stats["recall"][0] - recall[0]) < 1e-6, "localizer: the two recalls differ")
    require(identical, "localizer: poses differ from engine.localize's")
    require(len(lines) == len(queries), "localizer: poses.txt is incomplete")
    require("trace.json" in trace_files and trace_mb > 0, "localizer: no trace was written")
    require(sum(counts["mutual_nn_match"].values()) > 0,
            "localizer: the matcher kernel was not launched")


INLOC_FRAMES = 5  # retrieved RGB-D frames per query
# PnP-RANSAC's inlier threshold (px). The splatted scans blend the 3D points
# of neighbouring splats at a tenth of the keypoints (errors of 1–12 px);
# at 12 px those join the LO refit and move the pose by up to 0.15 m.
INLOC_THRESH = 4.0


def render_scan(map_index, image_id: int, width: int, height: int, rng):
    """A synthetic depth scan of a DB image [H, W, 3]: each keypoint's 3D
    point (where it has one) splatted over its 3×3 pixel neighbourhood,
    NaN everywhere else, and a tenth of the splats dropped as holes."""
    im = map_index.images[image_id]
    scan = np.full((height, width, 3), np.nan, np.float32)
    for (x, y), pid in zip(im.xys, im.point3D_ids):
        if pid < 0 or rng.random() < 0.1:
            continue
        xi, yi = int(round(x)), int(round(y))
        scan[max(yi - 1, 0): yi + 2, max(xi - 1, 0): xi + 2] = map_index.points3d[pid].xyz
    return scan


def phase_inloc(results, store, scene):
    """RGB-D localization (``localize_rgbd``) of the 8 corridor queries,
    each against its first ``INLOC_FRAMES`` retrieved frames with scans
    rendered from the scene's points: every query's pose within the
    localize bars (0.25 m, 2°), K2 launched."""
    rng = np.random.default_rng(SEED + 7)
    mi = scene.map_index
    scans = {}
    jobs = []
    for qname, q_gt, t_gt, near in scene.queries:
        entries = []
        for iid in near[:INLOC_FRAMES]:
            if iid not in scans:
                scans[iid] = render_scan(mi, iid, scene.width, scene.height, rng)
            f = store.read(mi.images[iid].name)
            entries.append((f.keypoints, f.descriptors, scans[iid]))
        fq = store.read(qname)
        jobs.append((fq.keypoints, fq.descriptors, entries, q_gt, t_gt))

    def run():
        return [localize_rgbd(kq, dq, entries, scene.cam_model, scene.cam_params,
                              ransac_thresh=INLOC_THRESH, device="cuda")
                for kq, dq, entries, _, _ in jobs]

    run()  # warm: captures PnP-RANSAC's graphs for these correspondence counts
    reset_launches()
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    counts = read_launches()
    results["main_path"].append(counts)
    errs = [pose_error(r["qvec"], r["tvec"], q_gt, t_gt) if r["success"] else (180.0, 1e9)
            for r, (_, _, _, q_gt, t_gt) in zip(res, jobs)]
    emit("inloc", queries=len(jobs), frames_per_query=INLOC_FRAMES, wall_s=wall,
         ms_per_query=wall * 1e3 / len(jobs), num_inliers=[r["num_inliers"] for r in res],
         rot_err_deg=[e[0] for e in errs], t_err_m=[e[1] for e in errs],
         match_launches=sum(counts["mutual_nn_match"].values()),
         match_shapes=[[*k, v] for k, v in counts["mutual_nn_match"].items()])
    require(sum(counts["mutual_nn_match"].values()) > 0, "inloc: the matcher kernel was not launched")
    for i, ((q_err, t_err), r) in enumerate(zip(errs, res)):
        require(r["success"] and q_err < 2.0 and t_err < 0.25,
                f"inloc: query {i} off by {q_err} deg, {t_err} m")


def device_profile(fn, sum_kernels: tuple = ()) -> dict:
    """One traced run of fn (torch.profiler, after the timed runs): wall
    time, device busy time and idle share, kernel launches, and the kernels
    and host-side torch ops that take the most time. `device_kernels`
    counts the kernels the card ran, `host_launch_calls` the host's launch
    calls (kernel launches and `cudaGraphLaunch`, `graph_launches` of
    them): a replayed graph runs its kernels on one host call. For each
    name part in `sum_kernels`, `kernel_ms_containing` sums the device ms
    and launches of the kernels whose names hold it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Kernel events only: a CPU-side op also reports its kernels' device
    # time, which would count that time twice.
    dev = sorted(((e.key[:90], e.self_device_time_total / 1e3, e.count) for e in events
                  if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in dev)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    count = lambda keys: sum(e.count for e in events if e.key in keys)  # noqa: E731
    launch_keys = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
                kernel_launches=count(("cudaLaunchKernel",)),
                device_kernels=sum(e.count for e in events if e.device_type == DeviceType.CUDA
                                   and not e.key.startswith(("Memcpy", "Memset"))),
                host_launch_calls=count(launch_keys + ("cudaGraphLaunch",)),
                graph_launches=count(("cudaGraphLaunch",)),
                top_kernels=[[k, round(ms, 3), n] for k, ms, n in dev[:8]],
                **({"kernel_ms_containing": {
                    part: [round(sum(ms for k, ms, _ in dev if part in k), 3),
                           sum(n for k, _, n in dev if part in k)] for part in sum_kernels}}
                   if sum_kernels else {}),
                gemm_in_top_kernels=[k for k, _, _ in dev[:8] if "gemm" in k.lower()],
                top_torch_ops_self_cpu=[[k, round(ms, 3), n] for k, ms, n in host[:8]])


def profile_query(eng, scene):
    """Where one query's time goes, after the timed run: a traced run
    (device_profile), then the port's host functions with the most
    cumulative time (cProfile, a second run)."""
    import cProfile
    import pstats

    qname, _, _, near = scene.queries[1]
    clusters = [[j] for j in near]
    traced = device_profile(lambda: eng.localize(qname, scene.qinfo, clusters))
    pr = cProfile.Profile()
    pr.enable()
    eng.localize(qname, scene.qinfo, clusters)
    torch.cuda.synchronize()
    pr.disable()
    funcs = sorted(((f"{Path(f).name}:{ln}:{fn}", v[3] * 1e3, v[1])
                    for (f, ln, fn), v in pstats.Stats(pr).stats.items() if "sfd2_torch" in f),
                   key=lambda r: -r[1])
    emit("localize_profile", **traced,
         top_port_functions_cum=[[k, round(ms, 3), n] for k, ms, n in funcs[:12]])
    require(traced["graph_launches"] >= 1, "localize_profile: the traced query launched no graph")


def device_sync(device):
    """A function that waits for the device's queued work (none on the CPU)."""
    return torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)


class StageTimer:
    """Seconds per stage of an entry point: for the duration of a `with`,
    the named module-level functions that the entry point calls are
    wrapped, and the card is synchronised after each call so that its work
    is counted in the stage. The last arguments and return value of each
    are kept."""

    def __init__(self, module, names, device):
        self.module, self.names = module, names
        self.sync = device_sync(device)
        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self.returned = {}
        self.args = {}
        self._orig = {}

    def __enter__(self):
        for name in self.names:
            fn = self._orig[name] = getattr(self.module, name)

            def timed(*args, _fn=fn, _name=name, **kwargs):
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                self.sync()
                self.seconds[_name] += time.perf_counter() - t0
                self.calls[_name] += 1
                self.returned[_name] = out
                self.args[_name] = args
                return out

            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.module, name, fn)

    def report(self) -> dict:
        return {name: dict(seconds=round(self.seconds[name], 3), calls=self.calls[name])
                for name in self.names}


class RecordBA:
    """For the duration of a `with`: every ``bundle_adjust`` call of the
    map phases (``run_map_build``'s own and ``incremental_reconstruction``'s)
    is kept with its arguments, result and seconds (the device
    synchronised), and bundle adjustment's graph statistics start from 0."""

    def __init__(self, device):
        self.sync = device_sync(device)

    def __enter__(self):
        self.calls, self.seconds = [], 0.0
        bundle_adjust.graph_captures = bundle_adjust.graph_replays = 0
        bundle_adjust.capture_s = 0.0

        def recorded(problem, **kwargs):
            t0 = time.perf_counter()
            res = bundle_adjust(problem, **kwargs)
            self.sync()
            self.seconds += time.perf_counter() - t0
            self.calls.append((problem, kwargs, res))
            return res

        self._orig = globals()["_run_ba"], sfm_reconstruction.bundle_adjust
        globals()["_run_ba"] = sfm_reconstruction.bundle_adjust = recorded
        return self

    def __exit__(self, *exc):
        globals()["_run_ba"], sfm_reconstruction.bundle_adjust = self._orig


_run_ba = bundle_adjust  # run_map_build's bundle_adjust (RecordBA swaps it)


def eager_ba(problem: BAProblem, kwargs: dict):
    """The problem through ``lm_setup``'s LM iteration stepped eagerly: what
    ``bundle_adjust`` replays from a CUDA graph on the card."""
    kwargs = dict(kwargs)
    lm_iters = kwargs.pop("lm_iters", 10)
    iterate, state = lm_setup(problem, **kwargs)
    for _ in range(lm_iters):
        state = iterate(state)
    return lm_result(state)


def ba_diff(got, ref) -> dict:
    """Largest differences of two BA results: both costs relative; poses
    (quaternions sign-aligned), translations and points absolute."""
    cost = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)
               for a, b in ((got.initial_cost, ref.initial_cost), (got.final_cost, ref.final_cost)))
    sign = torch.sign(torch.sum(got.qvecs * ref.qvecs, dim=1, keepdim=True))
    return dict(cost_rel=cost, qvec=(got.qvecs * sign - ref.qvecs).abs().max().item(),
                tvec=(got.tvecs - ref.tvecs).abs().max().item(),
                points=(got.points - ref.points).abs().max().item())


def same_bits(a, b) -> bool:
    """Two BA results equal bit for bit: poses, points and both costs."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def ba_against_eager(rec: RecordBA, what: str) -> dict:
    """The recorded ``bundle_adjust`` calls (on the card, LM replayed from a
    CUDA graph) beside the same problems through the same LM iteration
    stepped eagerly on the same device, per call: seconds of both (and of
    ``bundle_adjust`` run again after them, when nothing is loaded for the
    first time: ``ba_graph_warm_s``); the largest differences of graph and
    eager; and whether a second ``bundle_adjust`` and a second eager run
    give the first ones' bits (no deterministic-algorithms mode is set: the
    sums run in ``SegmentPlan``'s fixed order)."""
    out = dict(calls=len(rec.calls), ba_graph_s=rec.seconds, ba_eager_s=0.0,
               ba_graph_warm_s=0.0, graph_captures=bundle_adjust.graph_captures,
               graph_replays=bundle_adjust.graph_replays, capture_s=bundle_adjust.capture_s,
               deterministic_algorithms=torch.are_deterministic_algorithms_enabled(),
               graph_vs_eager=[], graph_runs_identical=0, eager_runs_identical=0,
               graph_equals_eager_bits=0)
    for problem, kwargs, got in rec.calls:
        rec.sync()
        t0 = time.perf_counter()
        ref = eager_ba(problem, kwargs)
        rec.sync()
        t1 = time.perf_counter()
        again = bundle_adjust(problem, **kwargs)
        rec.sync()
        out["ba_eager_s"] += t1 - t0
        out["ba_graph_warm_s"] += time.perf_counter() - t1
        out["graph_vs_eager"].append(ba_diff(got, ref))
        out["graph_runs_identical"] += same_bits(got, again)
        out["eager_runs_identical"] += same_bits(eager_ba(problem, kwargs), ref)
        out["graph_equals_eager_bits"] += same_bits(got, ref)
    return out


def check_ba_graph(rec: RecordBA, what: str):
    """A map phase's bundle adjustment on the card: it replayed a CUDA graph;
    its costs, poses and points stay within 1e-4 of the eager iteration's;
    and, without deterministic algorithms, a second run of every call gives
    the first one's bits, graph and eager alike."""
    out = ba_against_eager(rec, what)
    emit(f"{what}_ba", **out)
    require(out["graph_replays"] > 0, f"{what}: bundle adjustment replayed no CUDA graph")
    require(not out["deterministic_algorithms"], f"{what}: deterministic algorithms are on")
    for d in out["graph_vs_eager"]:
        require(max(d.values()) <= 1e-4, f"{what}: graph BA differs from eager: {d}")
    for k in ("graph_runs_identical", "eager_runs_identical"):
        require(out[k] == out["calls"], f"{what}: {k} {out[k]} of {out['calls']} BA calls")


def gt_point(map_index, image_id: int, kp: int):
    """Ground-truth xyz of a scene keypoint, or None if it sees no 3D point."""
    p = int(map_index.images[image_id].point3D_ids[kp])
    return map_index.point_xyz[map_index.point_row[p]] if p >= 0 else None


def point_errors(map_index, points3d, image_id_of) -> tuple:
    """(reconstructed xyz [P, 3], ground truth [P, 3]) of every point whose
    first observation sees a ground-truth point; image_id_of maps a model
    image id to the scene's."""
    rec, gt = [], []
    for pt in points3d.values():
        for iid, k in zip(pt.image_ids.tolist(), pt.point2D_idxs.tolist()):
            g = gt_point(map_index, image_id_of(iid), k)
            if g is not None:
                rec.append(pt.xyz)
                gt.append(g)
                break
    return np.array(rec).reshape(-1, 3), np.array(gt).reshape(-1, 3)


def map_ba_problem(cameras, images, points3d, device) -> BAProblem:
    """A map BA over a triangulated model, assembled as
    scripts/bench_scale.py does: every camera and point, the first two
    cameras fixed to pin the gauge."""
    iids = sorted(images)
    row = {iid: r for r, iid in enumerate(iids)}
    pids = sorted(points3d)
    img = np.concatenate([points3d[p].image_ids for p in pids]).astype(np.int64)
    kps = np.concatenate([points3d[p].point2D_idxs for p in pids]).astype(np.int64)
    obs_pt = np.repeat(np.arange(len(pids)), [len(points3d[p].image_ids) for p in pids])
    obs_xy = np.stack([images[i].xys[k] for i, k in zip(img.tolist(), kps.tolist())])
    cam8 = np.stack([canonicalize_params(cameras[images[i].camera_id].model,
                                         cameras[images[i].camera_id].params) for i in iids])
    fixed = np.zeros(len(iids), bool)
    fixed[:2] = True
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return BAProblem(
        obs_xy=f32(obs_xy), obs_cam=torch.as_tensor([row[i] for i in img.tolist()],
                                                    dtype=torch.int32, device=device),
        obs_point=torch.as_tensor(obs_pt, dtype=torch.int32, device=device),
        obs_w=torch.ones(len(obs_pt), device=device),
        qvecs=f32([images[i].qvec for i in iids]), tvecs=f32([images[i].tvec for i in iids]),
        cam_params=f32(cam8), points=f32([points3d[p].xyz for p in pids]),
        fixed_cams=torch.as_tensor(fixed, device=device))


def run_map_build(store, scene, device, max_keypoints: int, batch_size: int = 16,
                  check_roots: bool = True) -> dict:
    """The map-building slice (hloc/triangulation.py) on the scene's DB
    images: the reference model written with its observations stripped
    and read back, covis-20 DB pairs, NNM matching, ``triangulate_map``,
    then a map BA (lm_iters=2, cg_iters=8). Fails on any missed bar. With
    `check_roots` the native union-find's roots are held against the
    Python rule's on the edges of ``build_tracks``."""
    mi = scene.map_index
    sync = device_sync(device)
    sec = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref_dir = Path(tmp) / "reference"
        stripped = {iid: Image(iid, im.qvec, im.tvec, im.camera_id, im.name, np.zeros((0, 2)),
                               np.zeros(0, np.int64)) for iid, im in mi.images.items()}
        write_model(mi.cameras, stripped, {}, ref_dir)
        _, ref_images, ref_points = read_model(ref_dir)
        require(ref_images.keys() == mi.images.keys() and not ref_points
                and all(len(im.xys) == 0 for im in ref_images.values()),
                "map_build: the stripped reference model did not read back")

        t0 = time.perf_counter()
        pairs = pairs_from_covisibility(mi, num_matched=20)
        sec["pairs"] = time.perf_counter() - t0
        unique = {frozenset(p) for p in pairs}
        matches = MatchStore()
        t0 = time.perf_counter()
        n_matched = match_pairs(store, pairs, matches,
                                MatchConfig(matcher="NNM", max_keypoints=max_keypoints,
                                            batch_size=batch_size), device=device)
        sync()
        sec["match_pairs"] = time.perf_counter() - t0
        require(n_matched == len(unique) and all(matches.has_pair(a, b) for a, b in pairs),
                f"map_build: {n_matched} of {len(unique)} pairs matched")

        t0 = time.perf_counter()
        with StageTimer(sfm_pipeline, ("geometric_verification", "build_tracks",
                                       "triangulate_tracks"), device) as stages:
            cameras, images, points3d, stats = triangulate_map(ref_dir, store, matches, pairs,
                                                               None, TriangulationConfig(),
                                                               device=device)
        sec["triangulate_map"] = time.perf_counter() - t0

    # Every pair that shares ≥ 50 ground-truth points is verified.
    verified = {frozenset((a, b)) for a, b, _ in stages.returned["geometric_verification"]}
    covis = (mi.incidence @ mi.incidence.T).toarray()
    row = {n: r for r, n in enumerate(mi.names)}
    strong = {p for p in unique if covis[row[min(p)], row[max(p)]] >= 50}
    missed = len(strong - verified)
    require(missed == 0, f"map_build: {missed} of {len(strong)} pairs sharing ≥ 50 points not verified")
    rec, gt = point_errors(mi, points3d, lambda iid: iid)
    dist = np.linalg.norm(rec - gt, axis=1)
    med = float(np.median(dist)) if len(dist) else float("inf")
    require(med < 0.05, f"map_build: median point error {med} ≥ 0.05")
    require(stats["mean_reprojection_error"] < 1.0,
            f"map_build: mean reprojection error {stats['mean_reprojection_error']} ≥ 1 px")

    union_find = None
    if check_roots:  # the native union-find against the Python rule, same edges
        _, bounds, edges = track_edges(*stages.args["build_tracks"][:2])
        t0 = time.perf_counter()
        roots = native.union_find_roots(int(bounds[-1]), edges)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        same = np.array_equal(roots, union_find_roots_plain(int(bounds[-1]), edges))
        union_find = dict(nodes=int(bounds[-1]), edges=len(edges), native_s=native_s,
                          python_rule_s=time.perf_counter() - t0, identical_roots=same)
        require(same, "map_build: the native union-find's roots differ from the Python rule's")

    t0 = time.perf_counter()
    problem = map_ba_problem(cameras, images, points3d, device)
    res = _run_ba(problem, lm_iters=2, cg_iters=8)
    initial, final = float(res.initial_cost), float(res.final_cost)
    sec["bundle_adjust"] = time.perf_counter() - t0
    require(final < initial, f"map_build: BA cost {initial} → {final} did not fall")
    report = stages.report()
    return dict(seconds={k: round(v, 3) for k, v in sec.items()},
                verify_s=report["geometric_verification"]["seconds"],
                tracks_s=report["build_tracks"]["seconds"],
                union_find=union_find,
                triangulate_map_stages=report, pairs=len(pairs), unique_pairs=len(unique),
                verified_pairs=len(verified), strong_pairs=len(strong), points3D=stats["num_points3D"],
                mean_track_length=stats["mean_track_length"],
                mean_reprojection_error_px=stats["mean_reprojection_error"],
                median_point_error=med, points_with_gt=len(dist),
                ba_observations=int(problem.obs_xy.shape[0]), ba_initial_cost=initial,
                ba_final_cost=final)


def umeyama(src, dst):
    """Similarity transform (s, R, t) aligning src → dst."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    u, d, vt = np.linalg.svd(dc.T @ sc / len(src))
    s_fix = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s_fix[2, 2] = -1
    rot = u @ s_fix @ vt
    scale = np.trace(np.diag(d) @ s_fix) / ((sc ** 2).sum() / len(src))
    return scale, rot, mu_d - scale * rot @ mu_s


def run_reconstruct(store, scene, device, max_keypoints: int, n_images: int = 12,
                    batch_size: int = 16) -> dict:
    """``incremental_reconstruction`` from scratch on the first `n_images`
    DB images and their covis-20 pairs, matched with the NNR preset; held
    against ground truth after a Umeyama similarity fitted on points (the
    corridor's cameras are near-collinear, which leaves a fit on centres a
    free rotation), with the bars of tests/test_reconstruction.py."""
    mi = scene.map_index
    sync = device_sync(device)
    names = [mi.images[i].name for i in sorted(mi.images)[:n_images]]
    keep = set(names)
    pairs = [(a, b) for a, b in pairs_from_covisibility(mi, num_matched=20)
             if a in keep and b in keep]
    matches = MatchStore()
    t0 = time.perf_counter()
    match_pairs(store, pairs, matches, MatchConfig(matcher="NNR", max_keypoints=max_keypoints,
                                                   batch_size=batch_size), device=device)
    sync()
    match_s = time.perf_counter() - t0
    cams = {n: Camera(1, scene.cam_model, scene.width, scene.height, np.asarray(scene.cam_params))
            for n in names}
    t0 = time.perf_counter()
    with StageTimer(sfm_reconstruction, ("geometric_verification", "build_tracks",
                                         "triangulate_tracks", "pnp_ransac", "bundle_adjust"),
                    device) as stages:
        _, images, points3d, stats = incremental_reconstruction(
            store, matches, pairs, cams, ReconstructionConfig(), device=device)
    recon_s = time.perf_counter() - t0
    n_reg = stats["num_reg_images"]
    require(n_reg >= n_images - 2, f"reconstruct: {n_reg} of {n_images} images registered")
    scene_id = {iid: mi.name_to_image_id[im.name] for iid, im in images.items()}
    rec, gt = point_errors(mi, points3d, scene_id.get)
    require(len(rec) >= 8, f"reconstruct: only {len(rec)} points see ground truth")
    s, rot, tr = umeyama(rec, gt)
    dist = np.linalg.norm((s * (rot @ rec.T)).T + tr - gt, axis=1)
    med = float(np.median(dist))
    require(med < 0.05, f"reconstruct: median aligned point error {med} ≥ 0.05")
    centre_err = []
    for iid, im in images.items():
        ref = mi.images[scene_id[iid]]
        c_al = s * (rot @ camera_center(im.qvec, im.tvec)) + tr
        centre_err.append(float(np.linalg.norm(c_al - camera_center(ref.qvec, ref.tvec))))
    require(max(centre_err) < 0.1, f"reconstruct: camera centre error {max(centre_err)} ≥ 0.1")
    return dict(seconds=dict(match_pairs=round(match_s, 3), reconstruct=round(recon_s, 3)),
                stages=stages.report(), images=n_images, pairs=len(pairs), registered=n_reg,
                points3D=stats["num_points3D"], median_point_error=med,
                point_error_under_0_2=float((dist < 0.2).mean()),
                max_centre_error=max(centre_err))


def profile_entry(phase: str, fn):
    """Where an entry point's time goes, after its timed run: one traced run
    (device_profile), then the port's host functions with the most
    cumulative time (cProfile, a second run)."""
    import cProfile
    import pstats

    traced = device_profile(fn)
    pr = cProfile.Profile()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    funcs = sorted(((f"{Path(f).name}:{ln}:{name}", v[3] * 1e3, v[1])
                    for (f, ln, name), v in pstats.Stats(pr).stats.items() if "sfd2_torch" in f),
                   key=lambda r: -r[1])
    emit(phase, **traced, top_port_functions_cum=[[k, round(ms, 3), n] for k, ms, n in funcs[:12]])


def launches_by_shape(counts) -> dict:
    return {name: [[*k, v] for k, v in counts[name].items()] for name in KERNELS if counts[name]}


def phase_map_build(results, store, scene):
    reset_launches()
    with RecordBA("cuda") as rec:
        out = run_map_build(store, scene, "cuda", max_keypoints=4096)
    counts = read_launches()
    results["main_path"].append(counts)
    emit("map_build", **out, launches={k: sum(v.values()) for k, v in counts.items()},
         launch_shapes=launches_by_shape(counts))
    require(counts["mutual_nn_match"] and counts["gather_rows"],
            "map_build: K2 and K3 must both run")
    check_ba_graph(rec, "map_build")


def phase_reconstruct(results, store, scene):
    reset_launches()
    before = dict(graphs.stats)
    with RecordBA("cuda") as rec:
        out = run_reconstruct(store, scene, "cuda", max_keypoints=4096)
    counts = read_launches()
    results["main_path"].append(counts)
    pnp_graphs = {k: graphs.stats[k] - before[k] for k in before}
    emit("reconstruct", **out, launches={k: sum(v.values()) for k, v in counts.items()},
         launch_shapes=launches_by_shape(counts), pnp_graphs=pnp_graphs)
    require(counts["mutual_nn_ratio_match"] and counts["gather_rows"],
            "reconstruct: K4 and K3 must both run")
    require(pnp_graphs["replays"] > 0, "reconstruct: pnp_ransac replayed no CUDA graph")
    check_ba_graph(rec, "reconstruct")


def kernel_table(results, shapes: dict) -> list:
    """One row per kernel: launches on the main paths, and the numbers of
    the compared launch record where the main paths spent the most kernel
    time (launches × ms), with every compared record (``key``: the
    wrapper's shape-and-layout record) and its main-path launches under
    ``shapes``. The tensor-core kernels' rows (K1, the matchers) add the
    peak of ``bound_ms`` and the f32 bound on the CUDA cores, the matchers
    their bf16 time beside its bound."""
    table = []
    for name, k in KERNELS.items():
        rows = results[name]
        per_shape = [dict(key=list(key), launches=shapes[name].get(key, 0), **row)
                     for key, row in rows.items()]
        first = max(per_shape, key=lambda r: r["launches"] * r["ms"])
        table.append(dict(
            name=name, route=k["route"], source=k["source"], replaces=k["replaces"],
            launches=sum(shapes[name].values()),
            max_abs_err=max(r["max_abs_err"] for r in per_shape), ms=first["ms"],
            plain_ms=first["plain_ms"], bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=first["library_ms"],
            **{f: first[f] for f in ("bound_peak", "bf16_ms", "bf16_tc_bound_ms",
                                     "cuda_core_bound_ms") if f in first},
            shapes=[{f: r[f] for f in ("key", "launches", "max_abs_err", "ms", "bf16_ms",
                                       "graph_ms", "plain_ms", "bound_ms", "bound_by",
                                       "bf16_tc_bound_ms", "cuda_core_bound_ms", "library_ms",
                                       "kernel_device_ms", "library_device_ms",
                                       "conv1a_share") if f in r}
                    for r in per_shape]))
    return table


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    results = {"main_path": []}
    state = random_model_state(SEED)
    t_start = time.perf_counter()
    phase_build(results)
    stem_case = phase_kernel_stem(results, state)
    phase_kernel_match(results)
    phase_kernel_gather(results)
    phase_kernel_match_ratio(results)
    phase_kernel_nn(results, "nn_argmax")
    phase_kernel_nn(results, "nn_top2")
    phase_grouped_conv(results)
    # The main paths: extract (r1024, then multi-scale labelled r1600),
    # localize (sequential, pipelined, batched), serve, the localizer front
    # end, InLoc, map building, reconstruction and large-bank matching, each
    # with the counts set to 0 just before it and read just after.
    phase_extract(results, state)
    phase_extract_r1600_ms(results, state)
    store, scene, seq = phase_localize(results)
    phase_mesh(results, state, store, scene, seq)
    phase_serve(results, store, scene, seq)
    phase_localizer(results, store, scene, seq)
    phase_inloc(results, store, scene)
    phase_map_build(results, store, scene)
    phase_reconstruct(results, store, scene)
    phase_match_large(results)
    phase_baselines(results)
    phase_retrieval(results)
    with tempfile.TemporaryDirectory() as train_root:
        run_dir = phase_train(results, Path(train_root))
        phase_train_converge(results)
        phase_train_extract(results, run_dir)
        phase_train_sources(results, Path(train_root))

    shapes = {name: sum((run[name] for run in results["main_path"]), collections.Counter())
              for name in KERNELS}
    for name in KERNELS:
        require(sum(shapes[name].values()) > 0, f"{name}: not launched on the main path")
    # Every shape the main path launched is held against the plain version.
    cases = {"fused_stem": stem_case, "mutual_nn_match": match_case,
             "gather_rows": gather_case, "mutual_nn_ratio_match": ratio_case,
             "nn_argmax": functools.partial(nn_case, "nn_argmax"),
             "nn_top2": functools.partial(nn_case, "nn_top2")}
    for name, counts in shapes.items():
        for key in counts:
            if key not in results[name]:
                results[name][key] = cases[name](*key)
    # Where the map phases' time goes: a traced run and a cProfile run each.
    profile_entry("map_build_profile",
                  lambda: run_map_build(store, scene, "cuda", max_keypoints=4096,
                                        check_roots=False))
    profile_entry("reconstruct_profile",
                  lambda: run_reconstruct(store, scene, "cuda", max_keypoints=4096))
    table = kernel_table(results, shapes)
    emit("summary", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
