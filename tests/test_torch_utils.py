"""The port's utils (simlod_tpu_torch/utils/) on the CPU: hostutils against
the JAX package's copy (the cases of tests/test_utils.py, run on both), the
debug channel's single device read, and hot reload of modules and of the CUDA
sources (nothing is built here: a source change only drops the loaded
library)."""
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from simlod_tpu.utils import hostutils as jhostutils
from simlod_tpu_torch import kernels
from simlod_tpu_torch.utils import debugprint, hostutils, hotreload

torch.set_num_threads(1)

BOTH = pytest.mark.parametrize("hu", [hostutils, jhostutils],
                               ids=["port", "jax"])


def _wait(cond, seconds=5.0):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.02)
    return cond()


def _touch_later(path, text=None):
    """Rewrite (optionally) and move the mtime forward, so that a poller sees a
    change even within the file system's mtime granularity."""
    if text is not None:
        path.write_text(text)
    t = os.path.getmtime(path) + 10
    os.utime(path, (t, t))


@BOTH
def test_read_binary_file(hu, tmp_path):
    p = tmp_path / "x.bin"
    data = bytes(range(256))
    p.write_bytes(data)
    whole = hu.read_binary_file(str(p))
    np.testing.assert_array_equal(whole, np.frombuffer(data, np.uint8))
    part = hu.read_binary_file(str(p), 10, 5)
    np.testing.assert_array_equal(part, np.arange(10, 15, dtype=np.uint8))
    tgt = np.zeros(20, np.uint8)
    n = hu.read_binary_file_into(str(p), 250, 100, tgt, 2)
    assert n == 6  # clamped at EOF
    np.testing.assert_array_equal(tgt[2:8], np.arange(250, 256, dtype=np.uint8))
    assert len(hu.read_binary_file(str(p), 300)) == 0


@BOTH
def test_monitor_file(hu, tmp_path):
    p = tmp_path / "watched.txt"
    p.write_text("a")
    hits = []
    stop = hu.monitor_file(str(p), lambda: hits.append(1), interval_s=0.02)
    time.sleep(0.1)
    _touch_later(p, "bb")
    try:
        assert _wait(lambda: hits, 2.0)
    finally:
        stop.set()


@BOTH
def test_event_queue(hu):
    q = hu.EventQueue()
    out = []
    q.schedule(lambda: out.append("now"))
    q.schedule(lambda: out.append("later"), delay_s=10.0)
    q.schedule(lambda: out.append("soon"), delay_s=0.05)
    q.process()
    assert out == ["now"]
    assert _wait(lambda: q.process() or out == ["now", "soon"], 2.0)
    assert hu.now() > 0


@BOTH
def test_format_helpers(hu):
    assert hu.format_number(1234567) == "1,234,567"
    assert hu.format_number(1234.5678, 2) == "1,234.57"
    assert hu.format_bytes(3 * 1024 * 1024).endswith("MB")
    assert hu.format_bytes(512) == "512 B"
    assert [hostutils.format_bytes(n) for n in (0, 1 << 10, 5 << 40)] \
        == [jhostutils.format_bytes(n) for n in (0, 1 << 10, 5 << 40)]


def test_kv_channel_reads_once(monkeypatch):
    kv = debugprint.KVChannel()
    x = torch.arange(4.0)
    kv.set("mean", x.mean())
    kv.set("count", torch.tensor(1 << 40))
    kv.set("full", x.sum() > 100)
    kv.set("third", torch.tensor(1 / 3, dtype=torch.float64))
    reads = []
    for name in ("__bool__", "item", "tolist", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda t, *a, _o=orig, _n=name, **k:
                            reads.append(_n) or _o(t, *a, **k))
    syncs = debugprint.host_syncs
    host = debugprint.KVChannel.to_host(kv.values())
    assert reads == ["tolist"] and debugprint.host_syncs == syncs + 1
    assert host == {"mean": 1.5, "count": 1 << 40, "full": False,
                    "third": 1 / 3}
    assert isinstance(host["count"], int) and isinstance(host["full"], bool)
    assert debugprint.KVChannel.to_host({}) == {}


def test_dprint(capsys):
    syncs = debugprint.host_syncs
    debugprint.dprint("n={} m={}", torch.tensor(3), torch.tensor([1.5, 2.0]))
    assert capsys.readouterr().out == "n=3 m=[1.5, 2.0]\n"
    assert debugprint.host_syncs == syncs + 1


def test_hot_reload_reimports_a_changed_module(monkeypatch, tmp_path):
    name = f"hotpkg_{os.getpid()}"
    pkg = tmp_path / name
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "mod.py").write_text("VALUE = 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    mod = __import__(f"{name}.mod", fromlist=["VALUE"])
    calls = []
    # no CUDA sources to watch here: an empty source directory
    (tmp_path / "csrc").mkdir()
    monkeypatch.setattr(kernels, "SRC_DIR", tmp_path / "csrc")
    hr = hotreload.HotReloader(name, on_reload=[lambda: calls.append(1)])
    hr.start()
    try:
        time.sleep(0.15)
        _touch_later(pkg / "mod.py", "VALUE = 22\n")
        assert _wait(lambda: mod.VALUE == 22)
        assert calls
    finally:
        hr.stop()
        for m in [m for m in sys.modules if m.startswith(name)]:
            del sys.modules[m]


def test_hot_reload_drops_the_kernel_library(monkeypatch, tmp_path):
    """A change to a CUDA source drops the loaded library; its source hash
    (the library's name) changes, so the next launch builds the new one."""
    src = tmp_path / "csrc"
    shutil.copytree(kernels.SRC_DIR, src)
    monkeypatch.setattr(kernels, "SRC_DIR", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    loaded = object()
    monkeypatch.setattr(kernels, "_lib", loaded)
    before = kernels.library_path()
    hr = hotreload.HotReloader(f"no_such_package_{os.getpid()}")
    hr.start()
    try:
        time.sleep(0.15)
        cu = sorted(src.glob("*.cu"))[0]
        assert kernels._lib is loaded
        _touch_later(cu, cu.read_text() + "\n// edited\n")
        assert _wait(lambda: kernels._lib is None)
    finally:
        hr.stop()
    assert kernels.library_path() != before
    assert not (tmp_path / "build").exists()     # nothing was built
