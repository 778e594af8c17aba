"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root:  python3 chip_smoke.py

Builds every CUDA kernel of the query path from ``sfd2_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes, then
drives the main path — ``Extractor`` on four 1024² images with the
full-width ResSegNetV2 (random weights from a seed), and
``LocalizationEngine.localize`` on the synthetic corridor scene at the
production query shapes (4096 keypoints, 50 retrieved frames, C=128) —
with every kernel's launch count and launch-shape record set to 0 just
before each path and read just after. A shape the main path launched
that the kernel phases did not compare is compared afterwards, so every
launch shape is held against the plain version. Each phase prints one
JSON line; any failed check raises and the script exits non-zero without
a result. The last three lines are the kernel table (JSON), the card's
name and power limit as nvidia-smi gives them, and
``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Exits non-zero when CUDA is
not available.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sfd2_torch.geometry.np_pose import pose_error
from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.localization.engine import LocalizationEngine, LocalizerConfig
from sfd2_torch.models.sfd2 import ResSegNetV2
from sfd2_torch.ops import cuda_build
from sfd2_torch.ops.cuda_match import mutual_nn_match_cuda
from sfd2_torch.ops.cuda_stem import StemWeights, fused_stem_cuda
from sfd2_torch.ops.matching import mutual_nn_match
from sfd2_torch.ops.stem import fused_stem_apply, repack_stem_params, unpack_stem_params
from sfd2_torch.pipeline.extract import EXTRACTION_CONFS, ExtractionConfig, Extractor
from sfd2_torch.utils.synth import build_corridor_scene

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores
# and HBM bandwidth. The bound of a kernel is the larger of its operations
# over the first and its bytes over the second.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SEED = 0

KERNELS = {
    "fused_stem": dict(route="cuda", source="sfd2_torch/csrc/stem.cu",
                       replaces="sfd2_tpu/ops/pallas_stem.py:216", wrapper=fused_stem_cuda),
    "mutual_nn_match": dict(route="cuda", source="sfd2_torch/csrc/match.cu",
                            replaces="sfd2_tpu/ops/pallas_match.py:358",
                            wrapper=mutual_nn_match_cuda),
}


def emit(phase: str, **fields):
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


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         sources=cuda_build.kernel_sources(), ptxas=ptxas)


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

        flops = b * (2 * 27 * 64 * h * w + 2 * 576 * 64 * (h // 2) * (w // 2))
        nbytes = b * (h * w * 3 * 4 + (h // 2) * (w // 2) * 64 * 2)  # bf16 out
        bound_ms, bound_by = bound(flops, nbytes)
        row = dict(
            shape=[b, h, w, 3], max_abs_err=err, max_rel_err=rel, bf16_out_rel_err=rel16,
            ms=cuda_ms(lambda: fused_stem_cuda(x, weights, torch.bfloat16)),
            f32_out_ms=cuda_ms(lambda: fused_stem_cuda(x, weights, torch.float32)),
            plain_ms=cuda_ms(lambda: fused_stem_apply(x, weights.packed, torch.float32)),
            library_ms=cuda_ms(library), gflop=flops / 1e9, mbytes=nbytes / 1e6,
            bound_ms=bound_ms, bound_by=bound_by)
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


def match_case(b: int, n1: int, n2: int, c: int) -> dict:
    """K2 against its plain version at [B, N1, C] × [B, N2, C], f32 and
    bf16, with about 10 % invalid rows and columns; the query is broadcast
    to every bank with batch stride 0, as the engine does."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = unit(torch.randn((n1, c), generator=gen, device=dev))
    # Banks: half of each bank's rows are noisy copies of query rows, so real
    # mutual matches exist; the rest are unrelated.
    k = min(n1, n2) // 2
    src = torch.argsort(torch.rand((b, n1), generator=gen, device=dev), dim=1)[:, :k]
    bank = torch.randn((b, n2, c), generator=gen, device=dev)
    bank[:, :k] = q[src] + 0.3 * unit(bank[:, :k])
    bank = unit(bank)
    d0 = q[None].expand(b, n1, c)
    v0 = (torch.rand((1, n1), generator=gen, device=dev) > 0.1).expand(b, n1)
    v1 = torch.rand((b, n2), generator=gen, device=dev) > 0.1

    def check(dtype):
        a0, a1 = d0.to(dtype), bank.to(dtype)
        m_k, s_k = mutual_nn_match_cuda(a0, a1, v0, v1)
        m_p, s_p = mutual_nn_match(a0, a1, v0, v1)
        torch.cuda.synchronize()
        agree = (m_k == m_p).float().mean().item()
        alive = s_p != 0
        err = (s_k - s_p)[alive].abs().max().item()
        what = f"K2 {dtype} at {[b, n1, n2, c]}"
        require(agree >= 0.999, f"{what}: matches agree on {agree:.5f} < 0.999 of rows")
        require(err <= 1e-5, f"{what}: score err {err} > 1e-5")
        require(bool((s_k[~alive] == 0).all()), f"{what}: dead rows must score 0")
        return agree, err, int((m_k >= 0).sum().item())

    agree, err, n_match = check(torch.float32)
    agree16, err16, _ = check(torch.bfloat16)

    def library():
        s = torch.bmm(d0, bank.transpose(1, 2))
        rmax, nn12 = s.max(-1)
        return rmax == torch.gather(s.amax(-2), -1, nn12)

    flops = 2 * b * n1 * n2 * c
    nbytes = q.numel() * 4 + bank.numel() * 4 + n1 + v1.numel() + b * n1 * 8
    bound_ms, bound_by = bound(flops, nbytes)
    row = dict(
        shape=[b, n1, n2, c], agree=agree, max_abs_err=err, bf16_agree=agree16,
        bf16_max_abs_err=err16, matches=n_match,
        ms=cuda_ms(lambda: mutual_nn_match_cuda(d0, bank, v0, v1)),
        bf16_ms=cuda_ms(lambda: mutual_nn_match_cuda(
            d0.to(torch.bfloat16), bank.to(torch.bfloat16), v0, v1)),
        plain_ms=cuda_ms(lambda: mutual_nn_match(d0, bank, v0, v1)),
        library_ms=cuda_ms(library), gflop=flops / 1e9, mbytes=nbytes / 1e6,
        bound_ms=bound_ms, bound_by=bound_by)
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
    # (50 frames padded to [64, 4096, 128]).
    results["mutual_nn_match"] = {s: match_case(*s) for s in ((64, 4096, 4096, 128),
                                                             (1, 4096, 4096, 128))}
    tie_check()


def textured_images(n: int, size: int, seed: int):
    """Seeded synthetic textures: blocky colour noise at three scales."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = np.zeros((size, size, 3), np.float32)
        for cell, wgt in ((64, 0.5), (16, 0.3), (4, 0.2)):
            base = rng.random((size // cell, size // cell, 3)).astype(np.float32)
            img += wgt * np.kron(base, np.ones((cell, cell, 1), np.float32))
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
    emit("extract", images=[4, 1024, 1024, 3], keypoints_per_image=n_kp,
         ms_per_img=float(np.median(times)), ms_per_img_runs=times,
         stem_launches=fused_stem_cuda.launches,
         stem_shapes=[[*k, v] for k, v in fused_stem_cuda.shapes.items()],
         cpu_check=dict(keypoints=len(kc), agree=frac, desc_max_abs_err=float(derr)))
    emit("extract_profile", **device_profile(lambda: ex.extract_batch(images)))


def phase_localize(results):
    store = FeatureStore()
    t0 = time.perf_counter()
    scene = build_corridor_scene(store, n_images=60, n_queries=8, n_points=14000,
                                 kp_per_image=4096, kp_per_query=4096, desc_dim=128,
                                 retrieval_k=50, seed=7)
    build_s = time.perf_counter() - t0
    eng = LocalizationEngine(scene.map_index, store,
                             LocalizerConfig(max_keypoints=4096, pnp_pad_floor=4096),
                             device="cuda")
    reset_launches()
    per_q, errs, sources = [], [], []
    for i, (qname, q_gt, t_gt, near) in enumerate(scene.queries):
        t1 = time.perf_counter()
        res = eng.localize(qname, scene.qinfo, [[j] for j in near])
        if i > 0:  # query 0 pays the bank uploads
            per_q.append(time.perf_counter() - t1)
        errs.append(pose_error(res.qvec, res.tvec, q_gt, t_gt))
        sources.append(res.source)
    q_err = np.array([e[0] for e in errs])
    t_err = np.array([e[1] for e in errs])
    r1 = float(np.mean((t_err < 0.25) & (q_err < 2.0)))
    r2 = float(np.mean((t_err < 0.5) & (q_err < 5.0)))
    results["main_path"].append(read_launches())
    emit("localize", scene_build_s=build_s, e2e_query_ms=float(np.median(per_q)) * 1e3,
         per_query_ms=[x * 1e3 for x in per_q], recall_025m_2deg=r1, recall_05m_5deg=r2,
         med_terr_m=float(np.median(t_err)), med_rerr_deg=float(np.median(q_err)),
         sources=sources, match_launches=mutual_nn_match_cuda.launches,
         match_shapes=[[*k, v] for k, v in mutual_nn_match_cuda.shapes.items()])
    require(r1 >= 0.875, f"localize: recall@(0.25m, 2deg) {r1} < 0.875")
    require(mutual_nn_match_cuda.launches > 0, "localize: the matcher kernel was not launched")
    profile_query(eng, scene)


def device_profile(fn) -> dict:
    """One traced run of fn (torch.profiler, after the timed runs): wall
    time, device busy time and idle share, kernel launches, and the kernels
    and host-side torch ops that take the most time."""
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
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
                kernel_launches=sum(e.count for e in events if e.key == "cudaLaunchKernel"),
                top_kernels=[[k, round(ms, 3), n] for k, ms, n in dev[:8]],
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


def kernel_table(results, shapes: dict) -> list:
    """One row per kernel: launches on the main path, and the numbers of
    its first compared shape (the largest main-path launch), with every
    compared shape and its main-path launches under ``shapes``."""
    table = []
    for name, k in KERNELS.items():
        rows = results[name]
        per_shape = [dict(launches=shapes[name].get(key, 0), **row) for key, row in rows.items()]
        first = per_shape[0]
        table.append(dict(
            name=name, route=k["route"], source=k["source"], replaces=k["replaces"],
            launches=sum(shapes[name].values()),
            max_abs_err=max(r["max_abs_err"] for r in per_shape), ms=first["ms"],
            plain_ms=first["plain_ms"], bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=first["library_ms"],
            shapes=[{f: r[f] for f in ("shape", "launches", "max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")}
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
    # The main path: extract, then localize, each with the counts set to 0
    # just before it and read just after.
    phase_extract(results, state)
    phase_localize(results)

    shapes = {name: sum((run[name] for run in results["main_path"]), collections.Counter())
              for name in KERNELS}
    for name in KERNELS:
        require(sum(shapes[name].values()) > 0, f"{name}: not launched on the main path")
    # Every shape the main path launched is held against the plain version.
    cases = {"fused_stem": stem_case, "mutual_nn_match": match_case}
    for name, counts in shapes.items():
        for key in counts:
            if key not in results[name]:
                results[name][key] = cases[name](*key)
    table = kernel_table(results, shapes)
    emit("summary", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
