"""Finding the benchmark's parts by name: a module of one of its folders
(``drivers``, ``metrics``, ``references``) by its file name, and a JSON
file. A later cell, mix or metric is a new file; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of this package, loaded once by its
    path (a name may hold dots)."""
    path = os.path.join(HERE, folder, f"{name}.py")
    key = f"benchmark._{folder}.{name.replace('.', '_')}"
    if key in sys.modules and getattr(sys.modules[key], "__file__", None) == path:
        return sys.modules[key]
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder} module named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def reference(cfg: dict):
    """The plain reference that a configuration names."""
    return load_module("references", cfg["reference"])
