"""build.replayed_pct.load: the share of the build step's stretches that
replayed a CUDA graph (the program's `build.replay` spans) among all its
stretches (`build.replay`, `build.capture` and `build.eager`), in %, over
the run's loads. Nothing (None) where the program has none of these
spans."""
from lodbench import spans

STRETCH_SPANS = ("build.replay", "build.capture", "build.eager")


def read(rec):
    t = spans.totals()
    if not t:
        return None
    counts = {n: t[n]["count"] for n in STRETCH_SPANS if n in t}
    if not counts:
        return None
    return 100.0 * counts.get("build.replay", 0) / sum(counts.values())
