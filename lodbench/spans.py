"""The program's span totals (simlod_tpu_torch.utils.trace) as the readers
of the load's phases take them. The readers run in the run's own process
after the check, so the totals are those of every span the process closed:
the warm-up load's, the window's loads' and the traced stretch's. Nothing
(None) where the program has no such module."""
from __future__ import annotations


def totals() -> dict | None:
    """{span name: {count, seconds, sync_s}} of the process, or None."""
    try:
        from simlod_tpu_torch.utils import trace
    except ImportError:     # a program without spans
        return None
    return trace.since() or None


def load_seconds(t: dict) -> float | None:
    """The seconds of the loads: Engine.open and Engine.load_all."""
    if "engine.open" not in t or "engine.load_all" not in t:
        return None
    return t["engine.open"]["seconds"] + t["engine.load_all"]["seconds"]
