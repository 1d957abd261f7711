"""A run with the timed path broken underneath comes out not correct: a
step that returns its state unchanged, half of each batch left out, and an
answer altered where it is produced (a point's colour in the build, a
frame's pixels in the render). The cells run on one card, so no exchange
between chips can be left out. Each run is shrunk to the CPU (small.py)."""
import pytest

import small


def unchanged(fn):
    return lambda cfg, state, *a, **k: state


def half(fn, counts_at):
    def run(*a):
        a = list(a)
        a[counts_at] = a[counts_at] // 2
        return fn(*a)
    return run


def recoloured(fn):
    def run(*a, **k):
        state = fn(*a, **k)
        state.pt_rgba[:64] ^= 0x00010101 * 7
        return state
    return run


def painted(fn):
    def run(*a, **k):
        img, stats = fn(*a, **k)
        img = img.clone()
        img[40:80, 100:200] ^= 0x00404040
        return img, stats
    return run


@pytest.mark.parametrize("cell,fault", [
    ("simlod36m.load", "unchanged"), ("simlod36m.load", "half"),
    ("simlod36m.load", "recoloured"),
    ("simlod36m.orbit", "painted"),
    ("las73m.stream", "unchanged"), ("las73m.stream", "half"),
    ("las73m.stream", "painted")])
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    from simlod_tpu_torch import engine
    from simlod_tpu_torch.octree import build
    streamed = cell == "las73m.stream"
    if fault == "unchanged":
        name = "build_step" if streamed else "build_many"
        monkeypatch.setattr(build, name, unchanged(getattr(build, name)))
    elif fault == "half":
        name, at = ("build_step", 6) if streamed else ("build_many", 6)
        monkeypatch.setattr(build, name, half(getattr(build, name), at))
    elif fault == "recoloured":
        monkeypatch.setattr(build, "build_many",
                            recoloured(build.build_many))
    else:
        monkeypatch.setattr(engine, "render_frame",
                            painted(engine.render_frame))
    out = small.small_run(cell, seconds=0.3)
    # the stream's fused frames fail by the program's own fault (below):
    # the fault planted here has to fail another number
    failed = {k for k, (v, lim) in out["checks"].items() if v > lim}
    assert out["correct"] is False, out["checks"]
    assert failed - {"fused_frame_pixels_off_pct"}, out["checks"]


def test_the_same_runs_unbroken_are_correct():
    for cell in ("simlod36m.load", "simlod36m.orbit"):
        out = small.small_run(cell, seconds=0.3)
        assert out["correct"] is True, out["checks"]


def test_the_stream_fails_on_the_programs_fused_frames():
    """The program's own fault, as on the card (PERF.md, Open questions):
    a fused frame draws only the voxels compacted so far, none while the
    first load streams, where the reference draws every voxel stored. The
    octree and the frame after the drained load pass."""
    out = small.small_run("las73m.stream", seconds=0.3)
    checks = out["checks"]
    assert out["correct"] is False, checks
    assert [k for k, (v, lim) in checks.items() if v > lim] \
        == ["fused_frame_pixels_off_pct"], checks
