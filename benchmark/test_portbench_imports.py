"""CPU tests of what the benchmark imports: nothing under ``benchmark/``
imports JAX or the JAX package, top-level module names compared whole (the
port's name begins with the JAX package's), and the reference imports
nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "contrastyou_tpu"}
#: the modules the reference is made of, and what they may import
REFERENCE = ("portbench/reference.py", "portbench/inputs.py", "portbench/check.py")
PORT = "contrastyou_tpu_torch"


def imported_top_levels(path: Path) -> set:
    """Top-level names of every module ``path`` imports (relative imports
    are the benchmark's own)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_jax(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_names_compared_whole(tmp_path):
    port = tmp_path / "port.py"
    port.write_text("import contrastyou_tpu_torch.main\nfrom contrastyou_tpu_torch import ops\n")
    assert imported_top_levels(port) == {PORT} and not imported_top_levels(port) & FORBIDDEN
    jax_pkg = tmp_path / "jax_pkg.py"
    jax_pkg.write_text("from contrastyou_tpu.engine import steps\n")
    assert imported_top_levels(jax_pkg) & FORBIDDEN == {"contrastyou_tpu"}


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_nothing_of_the_port(name):
    assert PORT not in imported_top_levels(BENCH / name)


def test_reference_loads_without_the_port():
    code = ("import sys; import portbench.reference, portbench.inputs, portbench.check; "
            "loaded = {m.split('.')[0] for m in sys.modules}; "
            f"sys.exit(int(bool(loaded & set({sorted(FORBIDDEN | {PORT})!r}))))")
    assert subprocess.run([sys.executable, "-c", code], cwd=BENCH).returncode == 0
