"""Build and bind the package's CUDA kernels (simlod_tpu_torch/csrc/*.cu, with
the header they share, csrc/launch.cuh).

The sources are compiled with nvcc for Hopper (sm_90a) into one shared library
with a plain C interface, loaded with ctypes. The build happens at first use, never
at import, into simlod_tpu_torch/_build/, keyed by a hash of the sources and
flags; a later process with the same sources reuses the library. Each source is
compiled by its own nvcc, all started together, and the objects are linked
once. There is no fallback: a missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
from pathlib import Path

import torch

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
    srcs = sorted([*SRC_DIR.glob("*.cu"), *SRC_DIR.glob("*.cuh")])
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
    if t.dtype is dtype and t.get_device() == device.index \
            and t.is_contiguous() and (shape is None or t.shape == shape):
        return t.data_ptr()
    if not t.is_cuda:
        raise ValueError(f"{where}: {what} is on {t.device}; the kernel takes "
                         "CUDA tensors (its plain version takes the others)")
    if t.device != device:
        raise ValueError(f"{where}: {what} is on {t.device}, not {device}")
    raise ValueError(f"{where}: {what} must be a contiguous {dtype}"
                     + (f" of shape {tuple(shape)}" if shape is not None else ""))


# cudaErrorCooperativeLaunchTooLarge: a cooperative grid larger than what is
# co-resident on the card
COOPERATIVE_LAUNCH_TOO_LARGE = 720


def check_launch(rc: int, where: str) -> None:
    """Raises RuntimeError for a nonzero cudaError `rc` that the C entry point
    of kernel wrapper `where` returned."""
    if rc == 0:
        return
    why = (" (cudaErrorCooperativeLaunchTooLarge: the grid is larger than "
           "what is co-resident)" if rc == COOPERATIVE_LAUNCH_TOO_LARGE else "")
    raise RuntimeError(f"{where}: kernel launch failed (cudaError {rc}){why}")


# the cooperative kernels of csrc/frame.cu, as simlod_coop_grid numbers them
COOP_KERNELS = {"plan_blocks": 0, "visibility": 1}


def coop_grid(kernel: str, device) -> int:
    """The largest co-resident grid of a cooperative kernel of csrc/frame.cu
    on `device` (its blocks per SM times the SMs; the C side computes it once
    per device and caches it): no launch of it is larger."""
    g = load().simlod_coop_grid(COOP_KERNELS[kernel], device.index)
    check_launch(max(-g, 0), f"coop_grid({kernel!r})")
    return g


def last_grid(kernel: str) -> int:
    """The grid (blocks) that the last launch of a cooperative kernel of
    csrc/frame.cu in this process used, as the C entry point launched it
    (0 before its first launch)."""
    return load().simlod_last_grid(COOP_KERNELS[kernel])


# the kernel wrappers whose `.launches` count their kernels' launches
COUNTED: list = []


def counted(wrapper):
    """Registers a kernel wrapper in COUNTED, its `.launches` set to 0: the
    wrapper adds one for each launch it makes, and a CUDA graph's recording
    sets it back (graphs.record_cuda_graph), each replay adding what the
    recording launched."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper


@counted
def noop(device, cooperative: bool = False) -> None:
    """Launches the empty kernel of csrc/frame.cu (one block of 32 threads)
    on the current stream of `device` through the same ctypes path as the
    frame kernels, plainly or cooperatively: the launch floor. Adds one to
    `noop.launches`."""
    rc = load().simlod_noop(int(cooperative), device.index, stream(device))
    check_launch(rc, "noop")
    noop.launches += 1


# every view of an arena starts on this many bytes
ALIGN = 16


def arena_layout(nbytes, align: int = ALIGN) -> tuple[list[int], int]:
    """Byte offsets of consecutive chunks of nbytes[i] bytes, each on an
    `align`-byte boundary, and the arena's size (a multiple of `align`, at
    least `align`)."""
    offs, end = [], 0
    for n in nbytes:
        start = -(-end // align) * align
        offs.append(start)
        end = start + n
    return offs, max(-(-end // align) * align, align)


@functools.lru_cache(maxsize=256)
def carving(chunks: tuple, views: int) -> tuple:
    """How `carve` cuts an arena for `chunks` ((numel, dtype), ...), of
    which the first `views` become tensors (those of one dtype neighbours):
    each chunk on an ALIGN-byte boundary (arena_layout). Returns (arena
    bytes, chunk offsets, the byte sizes of one split of the arena into
    regions, runs): the odd regions are the dtype runs, each with its
    dtype, the element sizes of one split of it (alignment gaps included)
    and which parts are chunks (None: all)."""
    offs, total = arena_layout([n * dt.itemsize for n, dt in chunks])
    runs, regions, k = [], [], 0
    while k < views:
        dt = chunks[k][1]
        g0 = cur = offs[k]
        sizes, keep = [], []
        while k < views and chunks[k][1] == dt:
            gap = (offs[k] - cur) // dt.itemsize
            if gap:
                sizes.append(gap)
            keep.append(len(sizes))
            sizes.append(chunks[k][0])
            cur = offs[k] + chunks[k][0] * dt.itemsize
            k += 1
        regions += [g0 - sum(regions), cur - g0]
        runs.append((dt, tuple(sizes),
                     None if len(keep) == len(sizes) else tuple(keep)))
    if len({r[0] for r in runs}) != len(runs):
        raise ValueError("carving: the chunks of one dtype must be neighbours")
    regions.append(total - sum(regions))
    return total, tuple(offs), tuple(regions), tuple(runs)


def carve(device, chunks: tuple, views: int):
    """One torch.empty arena on `device` for `chunks` ((numel, dtype), ...):
    each chunk starts on an ALIGN-byte boundary and no two overlap. The
    first `views` chunks (those of one dtype neighbours) become tensors: the
    arena is split into one region per dtype, each region into its chunks;
    the others are scratch that only the kernel sees. A wrapper's outputs
    and scratch in one allocation. Returns (the tensors, the device pointer
    of every chunk)."""
    total, offs, regions, runs = carving(chunks, views)
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    out = []
    for r, (dt, sizes, keep) in zip(buf.split_with_sizes(regions)[1::2],
                                    runs):
        parts = r.view(dt).split_with_sizes(sizes)
        out += parts if keep is None else [parts[j] for j in keep]
    base = buf.data_ptr()
    return out, [base + o for o in offs]


def stream(device) -> int:
    """The current CUDA stream of `device` as the raw cudaStream_t (what
    torch.cuda.current_stream(device).cuda_stream gives, without making a
    Stream object)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def words(values) -> bytes:
    """int64 words packed for a C entry point's host array."""
    return struct.pack(f"{len(values)}q", *values)


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point's signature
    declared."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.simlod_tile_resolve.argtypes = [p, p, p, i, p, p, p]
            lib.simlod_tile_resolve.restype = i
            lib.simlod_splat_resolve.argtypes = [p, p, p, i, p, i, p, p, p, p, p]
            lib.simlod_splat_resolve.restype = i
            lib.simlod_splat_samples.argtypes = [p, i, p, p, p, p, p, i, i, i,
                                                 i, p, p, p, p, i, p]
            lib.simlod_splat_samples.restype = i
            lib.simlod_coop_grid.argtypes = [i, i]
            lib.simlod_coop_grid.restype = i
            lib.simlod_last_grid.argtypes = [i]
            lib.simlod_last_grid.restype = i
            lib.simlod_visibility.argtypes = [p, p, i, i, i, p]
            lib.simlod_visibility.restype = i
            lib.simlod_plan_blocks_many.argtypes = [p, i, i, p]
            lib.simlod_plan_blocks_many.restype = i
            lib.simlod_noop.argtypes = [i, i, p]
            lib.simlod_noop.restype = i
            lib.simlod_edl.argtypes = [p, p, i, i, p, p, i, p]
            lib.simlod_edl.restype = i
            ll = ctypes.c_longlong
            # csrc/morton.cu: the pointers, then the rows, device, stream
            for name, ptrs in (("route_keys", 9), ("decode_sorted", 7),
                               ("prefix_floor", 7), ("spill_floor", 9),
                               ("key_words", 8)):
                fn = getattr(lib, f"simlod_{name}")
                fn.argtypes = [p] * ptrs + [ll, i, p]
                fn.restype = i
            lib.simlod_node_keys.argtypes = [p] * 4 + [i, p, p, ll, i, p]
            lib.simlod_node_keys.restype = i
            _lib = lib
        return _lib
