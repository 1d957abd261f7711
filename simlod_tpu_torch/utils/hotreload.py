"""Hot reload (port of simlod_tpu/utils/hotreload.py) — the counterpart of the
reference's NVRTC kernel hot reload (C12).

The reference watches its .cu files and recompiles+relinks on save
(CudaModularProgram.h:181-185 + unsuck.hpp:700-730), letting you edit device
code while the app runs. Here device code is of two kinds, and both are
watched:
  - the package's Python modules (the torch ops): re-imported on change;
  - the CUDA sources, simlod_tpu_torch/csrc/*.cu: a change drops the loaded
    kernel library, so the next launch rebuilds it (kernels.load builds the
    library keyed by a hash of the sources, kernels/__init__.py).
PyTorch runs eagerly: there are no traced programs to clear. The on-reload
callbacks are kept.
"""
from __future__ import annotations

import importlib
import sys
import threading
from typing import Callable

from .. import kernels
from . import hostutils


class HotReloader:
    """Watches a package's modules and the CUDA sources; re-imports a changed
    module, drops the kernel library when a source changes.

    Usage:
        hr = HotReloader("simlod_tpu_torch", on_reload=[engine.rebind])
        hr.start()
    """

    def __init__(self, package: str = "simlod_tpu_torch",
                 on_reload: list[Callable[[], None]] | None = None):
        self.package = package
        self.on_reload = list(on_reload or [])
        self._stops: list[threading.Event] = []
        self._lock = threading.Lock()

    def _modules(self):
        return [m for name, m in list(sys.modules.items())
                if name.startswith(self.package) and getattr(m, "__file__", None)]

    def start(self):
        for mod in self._modules():
            stop = hostutils.monitor_file(
                mod.__file__, lambda m=mod: self.reload(m))
            self._stops.append(stop)
        for src in sorted(kernels.SRC_DIR.glob("*.cu")):
            self._stops.append(hostutils.monitor_file(str(src),
                                                      self.reload_kernels))
        return self

    def stop(self):
        for s in self._stops:
            s.set()
        self._stops.clear()

    def reload(self, module):
        with self._lock:
            importlib.reload(module)
            for cb in self.on_reload:
                cb()

    def reload_kernels(self):
        """Drop the loaded kernel library; the next launch builds the changed
        sources (a new source hash) and loads that library."""
        with self._lock:
            with kernels._lock:
                kernels._lib = None
            for cb in self.on_reload:
                cb()
