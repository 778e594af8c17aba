"""Run one cell of the benchmark once and print its result line.

  python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix,
driver, limits and per-layer metrics are found by name from
``BENCHMARK.json`` (``portbench/harness.py``). With ``--trace 0`` the
line's metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read in the same kind of run with ``torch.profiler``
over part of the window. Exits non-zero, printing no result, without a
CUDA device (or with fewer than the cell asks for), or if JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache at a fixed path inside the checkout: the
# program's nvcc outputs go to sfd2_torch/_build/ (fixed in its code).
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_ROOT / ".portbench_cache" / _dir)
os.environ["USE_FLAX"] = "0"
# One process, and one BLAS/OpenMP thread under each of its Python threads:
# the service's handler threads would otherwise each start a pool of
# their own on the host's few cores.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: float | None = None) -> tuple:
    """(result line without ``checks``, compared numbers with limits)."""
    import torch

    from portbench import harness

    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t_cuda = time.time()
    ctx = dict(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
               t_process=t_process if t_process is not None else time.time())
    out = cell.driver().run(ctx)
    out["numbers"]["cuda_ready_s"] = t_cuda - ctx["t_process"]
    compared, ok = harness.checks(out["numbers"], cell.limits)
    if trace:
        metrics = harness.read_per_layer(cell, out["layer_ctx"])
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(ok and out["failed"] == 0 and out["attempted"] > 0),
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": dev}
    if trace and out.get("trace"):
        t = out["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["card"] = harness.card_info() if device != "cpu" else None
    result["info"] = {k: v for k, v in out["numbers"].items() if k not in cell.limits}
    return result, compared


def main(argv=None) -> int:
    from portbench import harness

    t_process = harness.process_start_time()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.resolve(harness.load_manifest(_ROOT), args.workload, _ROOT)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, compared = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                t_process)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    harness.emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
