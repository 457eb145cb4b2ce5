"""Pickled-module ``.pt`` files for the tests of ``YOLOv10("x.pt")``.

``RefModule`` stands in for a reference model class: a module carrying its
``yaml`` dict and ``names`` whose ``state_dict()`` is a given mapping with
the reference's key names. ``missing_class_pickle`` writes a ``.pt`` whose
class lives in a module that is gone by the time the file is read.
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

import torch


class RefModule(torch.nn.Module):
    def __init__(self, state, yaml, names):
        super().__init__()
        self._state = dict(state)
        self.yaml = dict(yaml)
        self.names = dict(names)

    def state_dict(self, *args, **kwargs):
        return dict(self._state)


def missing_class_pickle(path: Path) -> Path:
    """A ``{"model": obj}`` checkpoint whose class's module no longer exists."""
    mod_dir = path.parent / "gone_pkg_src"
    mod_dir.mkdir(exist_ok=True)
    (mod_dir / "gone_ultralytics_stub.py").write_text(
        "import torch\n\nclass DetectionModel(torch.nn.Module):\n    pass\n")
    sys.path.insert(0, str(mod_dir))
    try:
        mod = importlib.import_module("gone_ultralytics_stub")
        torch.save({"model": mod.DetectionModel()}, path)
    finally:
        sys.path.remove(str(mod_dir))
        sys.modules.pop("gone_ultralytics_stub", None)
        (mod_dir / "gone_ultralytics_stub.py").unlink()
    return path
