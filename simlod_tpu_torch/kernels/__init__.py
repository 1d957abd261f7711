"""Build and bind the package's CUDA kernels (simlod_tpu_torch/csrc/*.cu).

The sources are compiled with nvcc for Hopper (sm_90a) into one shared library
with a plain C interface, loaded with ctypes. The build happens at first use, never
at import, into simlod_tpu_torch/_build/, keyed by a hash of the sources and
flags; a later process with the same sources reuses the library. Each source is
compiled by its own nvcc, all started together, and the objects are linked
once. There is no fallback: a missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: the HQS average must be an IEEE-rounded f32 division
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# seconds the last build in this process took (0.0 when the library was reused)
build_seconds: float | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from source at first use")
    return path


def library_path() -> Path:
    srcs = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"simlod_kernels-{h.hexdigest()[:16]}.so"


def compile_to(out: Path, cmd: list[str]) -> None:
    """Run the compiler command `cmd -o <tmp>` and move the per-process
    temporary file into `out`, so that concurrent processes never load a
    half-written library. A failed build raises."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*cmd, "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)


def build() -> Path:
    """Compile csrc/*.cu into the library (if not built yet): one nvcc per
    source, all started together, then one link; returns its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    t0 = time.perf_counter()
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    srcs = sorted(SRC_DIR.glob("*.cu"))
    objs = [out.with_suffix(f".{s.stem}.{os.getpid()}.o") for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
            for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    try:
        for cmd, p in zip(cmds, procs):
            log = p.communicate()[0]
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        compile_to(out, [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs)])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return out


def data_ptr(t, where: str, what: str, dtype, device, shape=None) -> int:
    """The device pointer of argument `what` of the kernel wrapper `where`;
    raises ValueError unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, when given) on `device`: a wrapper has no CPU fallback (its plain
    version `<name>_reference` takes CPU tensors)."""
    if not t.is_cuda:
        raise ValueError(f"{where}: {what} is on {t.device}; the kernel takes "
                         "CUDA tensors (its plain version takes the others)")
    if t.device != device:
        raise ValueError(f"{where}: {what} is on {t.device}, not {device}")
    if t.dtype != dtype or not t.is_contiguous() \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{where}: {what} must be a contiguous {dtype}"
                         + (f" of shape {tuple(shape)}" if shape is not None
                            else ""))
    return t.data_ptr()


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point's signature
    declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.simlod_tile_resolve.argtypes = [p, p, p, i, p, p, p]
            lib.simlod_tile_resolve.restype = i
            lib.simlod_splat_resolve.argtypes = [p, p, p, i, p, i, p, p, p, p, p]
            lib.simlod_splat_resolve.restype = i
            lib.simlod_splat_samples.argtypes = [p, i, p, p, p, p, p, i, i, i,
                                                 i, p, p, p, p, p]
            lib.simlod_splat_samples.restype = i
            lib.simlod_visibility.argtypes = [p, p, i, i, p]
            lib.simlod_visibility.restype = i
            lib.simlod_plan_blocks.argtypes = [p, i, i, i, p]
            lib.simlod_plan_blocks.restype = i
            lib.simlod_edl.argtypes = [p, p, i, i, ctypes.c_float, p, p]
            lib.simlod_edl.restype = i
            _lib = lib
        return _lib
