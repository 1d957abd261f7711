"""The benchmark's parts found by name: lodbench/<folder>/<name>.py (a
traffic loop, a file format, a per-layer metric), loaded by path, since a
name may hold dots. A later cell adds such a file and edits none."""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def module(folder: str, name: str):
    """lodbench/<folder>/<name>.py as a module (loaded once a process)."""
    key = f"lodbench.{folder}.{name.replace('.', '_')}"
    if key not in sys.modules:
        path = HERE / folder / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {folder} module {name!r} ({path.name})")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]
