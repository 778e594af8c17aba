"""The controls of the cells' checks, and the program's readings of the
compared numbers, each judged by the cell's own check.

  python3 -m portbench.control --workload <cell> --seeds 11,12,13 [--program] [--device cuda]

A control is the reference put in the program's place and computed one
precision below the configuration's, or the program with a fault planted
in it; its answers go through the cell's driver's ``verify`` and
``harness.checks``, as a run's answers do, and a sound check reads
``correct`` false for it. Each driver kind keeps its controls in
``portbench/controls/<kind>.py`` (``controls/__init__.py`` says what such a
file defines), found by the name of the cell's mix's driver. With
``--program`` the program's own answers of one timed-size call are judged
instead: the readings a limit is set above, many seeds in one process.
Prints one JSON line per seed and control the kind names: ``correct`` and
each compared number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness
from portbench.controls import full_precision


def controls_of(cell):
    """The cell's kind's ``controls/<kind>.py``, from the cell's checkout."""
    kind = cell.mix["driver"]
    return harness.load_module(cell.root / "portbench" / "controls" / f"{kind}.py",
                               f"portbench_control_{kind}")


def judge(cell, seed: int, device, program: bool = False, which: str | None = None) -> dict:
    """{"correct", "checks", "info"} of control `which`'s answers (one of
    the kind's ``CONTROLS``) or, with `program`, of the program's."""
    mod = controls_of(cell)
    with full_precision():
        numbers = (mod.program(cell, seed, device) if program
                   else mod.control(cell, seed, device, which))
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
    sides = [{"side": "program"}] if args.program else [
        {"side": "control", "control": which} for which in controls_of(cell).CONTROLS]
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in sides:
            out = judge(cell, seed, args.device, args.program, side.get("control"))
            print(json.dumps({"workload": cell.name, "seed": seed, **side, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
