"""Config handling: argparse + JSON overlay + run-dir arg snapshots.

Port of ``sfd2_tpu/utils/config.py``: the reference's argparse defaults
overlaid by a JSON file (``train.py:176-179``) as `apply_json_overlay`,
`save_args` / `load_args` (``tools/common.py:53-60``), typed dataclasses
built from plain dicts, and `model_size` over a module's parameters.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Any, Dict



def apply_json_overlay(args: argparse.Namespace, config_path) -> argparse.Namespace:
    """Override argparse defaults with values from a JSON file."""
    if config_path:
        overrides = json.loads(Path(config_path).read_text())
        for k, v in overrides.items():
            setattr(args, k, v)
    return args


def save_args(args: argparse.Namespace, path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        k: (str(v) if isinstance(v, Path) else v) for k, v in vars(args).items()
    }
    path.write_text(json.dumps(payload, indent=2, default=str))


def load_args(path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


def dataclass_from_dict(cls, data: Dict[str, Any]):
    """Build a (possibly nested) dataclass from a plain dict, ignoring
    unknown keys."""
    if not dataclasses.is_dataclass(cls):
        return data
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            continue
        ftype = fields[k].type
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            kwargs[k] = dataclass_from_dict(ftype, v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def model_size(module) -> int:
    """Total parameter count of a module (``tools/common.py`` model_size)."""
    return sum(p.numel() for p in module.parameters())
