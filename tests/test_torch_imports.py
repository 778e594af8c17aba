"""The port stands alone: importing every ``sfd2_torch`` module, or
``chip_smoke.py``, loads nothing of JAX, Flax, optax or the JAX package, builds
no kernel, and ``chip_smoke.py`` refuses to run without a card."""

import ast
import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import sfd2_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sfd2_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(sfd2_torch.__path__, "sfd2_torch."))


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_lists_the_slice_modules():
    mods = set(_port_modules())
    for name in ("geometry.rotations", "geometry.cameras", "geometry.np_pose",
                 "models.layers", "models.sfd2", "models.convert", "ops.stem",
                 "ops.cuda_stem", "ops.nms", "ops.resize", "ops.grid_sample",
                 "ops.extract", "io.feature_store", "pipeline.extract", "ops.matching",
                 "ops.cuda_match", "localization.pnp", "localization.ransac",
                 "sfm.map_index", "localization.engine", "utils.synth", "io.colmap_model",
                 "ops.gather", "ops.cuda_gather", "ops.cuda_match_ratio", "pipeline.match",
                 "sfm.pairs", "sfm.twoview", "sfm.tracks", "sfm.triangulation", "sfm.stats",
                 "sfm.pipeline", "sfm.ba", "sfm.reconstruction", "ops.cuda_nn_argmax",
                 "ops.cuda_nn_top2", "io.pairs", "io.database", "cli.pairs_from",
                 "cli.match_features", "cli.triangulation", "cli.reconstruction",
                 "localization.graphs", "serving.server", "cli.serve", "native",
                 "geometry.pose", "utils.profiling", "localization.localizer",
                 "cli.localizer", "localization.inloc", "cli.extract_features", "io.nvm",
                 "cli.colmap_from_nvm", "models.superpoint", "models.r2d2",
                 "models.baselines", "models.retrieval", "models.convert_baselines",
                 "pipeline.extractors", "cli.extract_global", "models.convnext",
                 "models.upernet", "training.semantics", "training.transforms",
                 "training.data", "training.ap_loss", "training.sampler",
                 "training.extra_losses", "training.losses", "training.train_step",
                 "training.trainer", "training.seg_teacher", "utils.config",
                 "utils.tb_writer", "cli.train"):
        assert f"sfd2_torch.{name}" in mods, name


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_imports_load_nothing_of_jax(target):
    mods = _port_modules() if target == "package" else ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    assert _run(code) == []


def test_import_builds_nothing():
    code = (
        "import importlib, json\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "from sfd2_torch import native\n"
        "from sfd2_torch.ops import cuda_build\n"
        "print(json.dumps(sorted(cuda_build._libs) + ([] if native._lib is None else ['tracks'])))\n"
    )
    assert _run(code) == []  # no kernel or host library was built or loaded


def test_kernel_sources_are_in_the_package():
    from sfd2_torch.ops import cuda_build

    assert cuda_build.kernel_sources() == ["gather", "match", "match_ratio", "nn_argmax",
                                           "nn_top2", "stem"]
    for name in cuda_build.kernel_sources():
        text = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces: sfd2_tpu/ops/pallas_" in text  # header note
        included = "".join((cuda_build.CSRC / h).read_text()
                           for h in re.findall(r'#include "(\w+\.cuh)"', text))
        assert 'extern "C"' in text and "cudaGetLastError" in text + included
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _top_level_names(path: Path, with_imports: bool) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    """Each public function, class and constant that a module of the JAX
    package defines is defined (or re-exported) by the port's module of the
    same path; the Pallas modules are replaced by ``csrc/*.cu``."""
    missing = {}
    for ref in sorted((ROOT / "sfd2_tpu").rglob("*.py")):
        if ref.name.startswith("pallas_"):
            continue
        port = ROOT / "sfd2_torch" / ref.relative_to(ROOT / "sfd2_tpu")
        assert port.exists(), port
        gap = _top_level_names(ref, False) - _top_level_names(port, True)
        if gap:
            missing[str(ref.relative_to(ROOT))] = sorted(gap)
    assert missing == {}
