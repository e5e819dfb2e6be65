"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program."""

import ast
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parent.parent
ROOT = SRC.parent
BANNED = {"jax", "jaxlib", "flax", "dpg_slam_tpu"}


def _imports(path: pathlib.Path) -> set[str]:
    """Every module a file imports, by full dotted name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(SRC.rglob("*.py"))
    assert SRC / "run.py" in files and SRC / "reference" / "dpg.py" in files
    for f in files:
        bad = {n.split(".")[0] for n in _imports(f)} & BANNED
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    allowed = {"torch", "numpy", "copy", "math", "types", "__future__"}
    for f in sorted((SRC / "reference").glob("*.py")):
        for n in _imports(f):
            top = n.split(".")[0]
            assert top != "dpg_slam_tpu_torch", f"{f.name} imports {n}"
            assert top in allowed or n.startswith("slambench.reference"), f"{f.name} imports {n}"


_RUN = """
import sys
sys.modules["jax"] = None
sys.modules["dpg_slam_tpu"] = None
import pathlib, tempfile
sys.path.insert(0, {root!r})
from slambench import run
from slambench.tests import tiny
with tempfile.TemporaryDirectory() as d:
    spec = tiny.spec(pathlib.Path(d), "fleet.track64")
    out = run.run_cell(spec, 11, 0.0, False, device="cpu")
assert out["checks"], out
loaded = {{m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}}
print(sorted(loaded & set({banned!r})))
"""


def test_a_run_loads_no_jax():
    code = _RUN.format(root=str(ROOT), banned=sorted(BANNED))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
