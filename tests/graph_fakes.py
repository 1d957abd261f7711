"""The CPU's stand-in for graphs.record_cuda_graph, shared by the tests of
both graph caches (tests/test_torch_graph.py, test_torch_build_graphs.py).

It keeps the recorder's meaning: a recording runs nothing, and each replay
of the "graph" runs the recorded span again, so a replay reads and writes
exactly the tensors a real graph would have frozen. Its `outputs` are those
of the last replay."""


class FakeRecord:
    """record(span, device) for the CPU; raises `fail` if one is given."""

    def __init__(self, fail=None):
        self.spans = []
        self.fail = fail

    def __call__(self, span, device):
        if self.fail is not None:
            raise self.fail
        self.spans.append(span)
        return FakeGraph(span)


class FakeGraph:
    def __init__(self, span):
        self.span = span
        self.outputs = None
        self.replays = 0

    def replay(self):
        self.outputs = self.span()
        self.replays += 1
