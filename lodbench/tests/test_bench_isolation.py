"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the reference loads nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent

RUN = """
import json, sys
sys.path[:0] = [{root!r}, {here!r}]
import small
from lodbench.run import forbidden_modules
out = small.small_run({cell!r}, seconds=0.3)
print(json.dumps(dict(correct=out["correct"], found=forbidden_modules())))
"""


@pytest.mark.parametrize("cell", ["simlod36m.load", "simlod36m.orbit",
                                  "las73m.stream"])
def test_a_run_of_each_traffic_loop_loads_no_jax(cell):
    res = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), here=str(HERE),
                                          cell=cell)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    # the stream's fused frames draw no voxel that is not yet compacted,
    # so its run reads not correct (PERF.md, Open questions)
    assert out == dict(correct=cell != "las73m.stream", found=[])


def test_the_forbidden_names_are_whole_top_level_names():
    from lodbench import run as R
    saved = dict(sys.modules)
    try:
        sys.modules["simlod_tpu_torch_x"] = sys
        sys.modules["jaxtyping"] = sys
        assert "simlod_tpu_torch_x" not in R.forbidden_modules()
        assert "jaxtyping" not in R.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert R.forbidden_modules() == ["jax"] or "jax" in saved
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


REFERENCE = ["reference.py", "found.py"] + sorted(
    f"formats/{p.name}" for p in (ROOT / "lodbench/formats").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE)
def test_the_reference_loads_nothing_of_the_program(path):
    """The reference and the format readers it decodes the file with."""
    src = (ROOT / "lodbench" / path).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "os", "struct", "importlib",
                     "pathlib", "sys", "numpy", "torch", "lodbench"}
    fmts = [p.split("/")[1][:-3] for p in REFERENCE if "/" in p]
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import lodbench.reference; from lodbench import found; "
            f"[found.module('formats', f) for f in {fmts!r}]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'simlod_tpu_torch', 'simlod_tpu', 'jax'}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.stdout.strip() == "[]", res.stderr
