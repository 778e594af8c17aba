"""Nothing the harness runs loads JAX or the JAX package, and the plain
references load nothing of the program; modules are compared by their
top-level name (the part before the first dot), whole."""

import json
import subprocess
import sys

from portbench import harness

REFERENCE = """
import json, sys
import portbench.reference.localize, portbench.reference.match, portbench.reference.pose
import portbench.reference.precision, portbench.reference.sfd2, portbench.reference.mapbuild
import portbench.covis
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

HARNESS = """
import json, sys
sys.path.insert(0, "portbench/tests")
import tiny
tiny.run_line(tiny.serve_cell(), seconds=1.0, trace=True)
tiny.run_line(tiny.extract_cell(), seconds=1.0, trace=True)
import portbench.control
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_references_load_no_program_and_no_jax():
    names = top_level(REFERENCE)
    assert not names & {"sfd2_torch", "sfd2_tpu", "jax", "jaxlib", "flax"}
    assert "portbench" in names


def test_harness_loads_no_jax():
    names = top_level(HARNESS)
    assert "sfd2_torch" in names
    assert not names & set(harness.FORBIDDEN)
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "sfd2_tpu")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sfd2_tpu_lookalike", sys)
    assert "sfd2_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sfd2_tpu.models", sys)
    assert "sfd2_tpu" in harness.forbidden_modules()
