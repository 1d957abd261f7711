"""Host utilities (the reference's unsuck.hpp, C17); a copy of
simlod_tpu/utils/hostutils.py, which is pure numpy and threading.

Only the pieces the engine actually uses are replicated: wall-clock `now()`, binary
file reading (whole / range / into-target), file monitoring for hot reload, a scheduled
event queue, and human-readable formatting. Platform shims the reference needs for
Win32 (thread priority, sector size, clipboard) have no meaning here.
"""
from __future__ import annotations

import heapq
import os
import threading
import time
from typing import Callable

import numpy as np

_T0 = time.perf_counter()


def now() -> float:
    """Seconds since program start (reference unsuck.hpp:215)."""
    return time.perf_counter() - _T0


def read_binary_file(path: str, first: int = 0, size: int | None = None) -> np.ndarray:
    """Read a whole file or a byte range as uint8 (reference unsuck.hpp:390-496)."""
    total = os.path.getsize(path)
    if size is None:
        size = total - first
    size = max(0, min(size, total - first))
    with open(path, "rb") as f:
        f.seek(first)
        return np.frombuffer(f.read(size), dtype=np.uint8)


def read_binary_file_into(path: str, first: int, size: int, target: np.ndarray,
                          target_offset: int = 0) -> int:
    data = read_binary_file(path, first, size)
    target[target_offset:target_offset + len(data)] = data
    return len(data)


def monitor_file(path: str, callback: Callable[[], None],
                 interval_s: float = 0.1) -> threading.Event:
    """Invoke callback whenever the file's mtime changes (reference unsuck.hpp:700-730).

    Returns a stop Event; set it to end monitoring.
    """
    stop = threading.Event()

    def loop():
        try:
            last = os.path.getmtime(path)
        except OSError:
            last = 0.0
        while not stop.is_set():
            time.sleep(interval_s)
            try:
                m = os.path.getmtime(path)
            except OSError:
                continue
            if m != last:
                last = m
                callback()

    threading.Thread(target=loop, daemon=True).start()
    return stop


class EventQueue:
    """Deferred/scheduled host callbacks (reference unsuck.hpp:671-698)."""

    def __init__(self):
        self._heap: list = []
        self._lock = threading.Lock()
        self._seq = 0

    def schedule(self, fn: Callable[[], None], delay_s: float = 0.0):
        with self._lock:
            heapq.heappush(self._heap, (now() + delay_s, self._seq, fn))
            self._seq += 1

    def process(self):
        """Run all due callbacks (call once per frame, like the reference loop)."""
        while True:
            with self._lock:
                if not self._heap or self._heap[0][0] > now():
                    return
                _, _, fn = heapq.heappop(self._heap)
            fn()


def format_number(n: float, digits: int = 1) -> str:
    """Locale-style grouped formatting (reference printfmt/format helpers)."""
    if float(n).is_integer():
        return f"{int(n):,}"
    return f"{n:,.{digits}f}"


def format_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.1f} PB"
