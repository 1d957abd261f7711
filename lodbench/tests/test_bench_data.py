"""The seeded generator (deterministic, and the port's terrain in
distribution) and the file writers (read back by the port's readers and by
the reference)."""
import numpy as np
import pytest
import torch

from lodbench import data, found
from lodbench import reference as ref

CPU = torch.device("cpu")


def test_the_same_seed_gives_the_same_scan():
    a = data.terrain(20_000, 2 ** 31 + 5, CPU)
    b = data.terrain(20_000, 2 ** 31 + 5, CPU)
    c = data.terrain(20_000, 2 ** 31 + 6, CPU)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_the_terrain_is_the_ports_in_distribution():
    from simlod_tpu_torch.formats import synthetic
    n = 200_000
    xyz, rgba = data.terrain(n, 7, CPU)
    xyz = xyz.numpy()
    want, want_c = synthetic.terrain(n, seed=7)
    qs = np.linspace(0.05, 0.95, 19)
    for axis, span in enumerate((1000.0, 1000.0, 120.0)):
        got = np.quantile(xyz[:, axis], qs)
        exp = np.quantile(want[:, axis], qs)
        # the clutter's highest lift sets the height scale: seeds of the
        # port's own generator differ by up to 1.3% of the height
        assert np.abs(got - exp).max() < 0.03 * span
    # the clutter: 1/12 of the points lifted off the smooth surface
    assert abs(np.mean(xyz[:, 2]) - np.mean(want[:, 2])) < 0.03 * 120
    r = rgba.numpy().view(np.uint32) & 0xFF
    assert abs(r.mean() - (want_c & 0xFF).mean()) < 0.03 * 180
    # scan-line order: neighbours in the file are neighbours in space
    step = np.median(np.linalg.norm(np.diff(xyz[:, :2], axis=0), axis=1))
    exp_step = np.median(np.linalg.norm(np.diff(want[:, :2], axis=0), axis=1))
    assert step == pytest.approx(exp_step, rel=0.05)


@pytest.mark.parametrize("fmt", ["simlod", "las"])
def test_writers_read_back(tmp_path, fmt):
    from simlod_tpu_torch.formats import las, simlod
    xyz, rgba = data.terrain(30_000, 3, CPU)
    writer = found.module("formats", fmt)
    path = str(tmp_path / ("scan" + writer.SUFFIX))
    writer.write(path, xyz, rgba)
    scan = ref.read_scan(path, fmt, CPU)
    mn = xyz.min(0).values
    if fmt == "simlod":
        got, got_c = simlod.read_points(path)
        assert torch.equal(scan.xyz, xyz - mn)
    else:
        got, got_c = las.read_points(path)
        assert (scan.xyz - (xyz - mn)).abs().max() <= 0.0005 + 1e-4
    assert np.array_equal(got, scan.xyz.numpy())
    assert np.array_equal(got_c.view(np.int32), scan.rgba.numpy())
    assert torch.equal(scan.rgba, rgba)
    extent = (xyz.max(0).values - mn).double()
    assert ref.scan_extent(path, fmt) == pytest.approx(extent.tolist(), abs=1e-3)
    assert float(scan.cube) == pytest.approx(float(extent.max()), abs=1e-3)
