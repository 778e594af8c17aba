"""What every cell shares: the manifest, finding a cell's files by name,
the result line, and the checks made before it is printed.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the names in
``BENCHMARK.json``:

  <the configuration's "file">            its sizes and knobs
  portbench/mixes/<traffic>.json          {"driver": <kind>, ...parameters}
  portbench/drivers/<kind>.py             run(ctx) -> dict
  portbench/limits/<workload>.json        the limits of the cell's check
  portbench/controls/<kind>.py            the controls of the kind's check (control.py)
  portbench/metrics/<metric>.py           read(ctx) -> float | None, or else
  portbench/metrics/<prefix>.py           for a metric named <prefix>.<cells>: one
                                          reader for a quantity read in several cells
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "sfd2_tpu")


def process_start_time() -> float:
    """The process's start on the ``time.time`` clock (Linux /proc)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        boot = next(float(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + int(fields[19]) / ticks
    except (OSError, StopIteration, ValueError, IndexError):
        return time.time()


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload resolved to its files."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT

    def driver(self):
        path = self.root / "portbench" / "drivers" / f"{self.mix['driver']}.py"
        return load_module(path, f"portbench_driver_{self.mix['driver']}")


def resolve(manifest: dict, workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "portbench" / "mixes" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    # A per-layer metric without "workloads" is read in every cell that
    # reports the end-to-end metric it moves, cells added later included.
    per_layer = [m for m in manifest["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(workload, int(w["chips"]), config, mix, limits["limits"], e2e, per_layer, root)


def reader_path(root: Path, name: str) -> Path:
    """``metrics/<name>.py``, or ``metrics/<name before the first dot>.py``."""
    own = root / "portbench" / "metrics" / f"{name}.py"
    return own if own.exists() else own.with_name(f"{name.split('.')[0]}.py")


def read_per_layer(cell: Cell, ctx: dict) -> dict:
    """Each per-layer metric's reader, by name; a reader that finds
    nothing returns None and its metric is left out."""
    out = {}
    for i, m in enumerate(cell.per_layer):
        path = reader_path(cell.root, m["name"])
        value = load_module(path, f"portbench_metric_{i}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def checks(numbers: dict, limits: dict) -> tuple:
    """({name: {"value", "limit"}}, all within their limits)."""
    out = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in out.values())
    return out, ok


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_info() -> str | None:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def emit(result: dict, compared: dict, out=None, err=None) -> None:
    """Each compared number beside its limit as the last lines on stderr,
    then the result line, with those numbers under ``checks``, last, on
    stdout."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in compared.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps({**result, "checks": compared}), file=out, flush=True)
