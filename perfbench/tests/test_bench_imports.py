"""Nothing a run of a cell loads is JAX or the JAX package (top-level
names compared whole: the port's ``repro_torch`` begins with ``repro``),
and the reference imports nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO, make_tiny
from perfbench import harness

RUN_ALL = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import harness, run  # what run.py imports
harness.prepare_env()
result = harness.run_cell({cell!r}, 5, 1.0, {traced}, device="cpu")
print(json.dumps(sorted(sys.modules)))
"""


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["tmux-cls", "qwen-score", "qwen-serve"])
def test_a_run_loads_no_jax(tmp_path, cell, traced):
    make_tiny(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", RUN_ALL.format(root=str(tmp_path), cell=cell,
                                              traced=traced)],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in modules}
    assert not tops & set(harness.FORBIDDEN)
    assert "repro_torch" in tops          # the program did run


def imports_of(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        assert not imports_of(path) & {"repro_torch", *harness.FORBIDDEN}, \
            path
    code = ("import sys; sys.path.insert(0, {!r}); "
            "import perfbench.reference.model, perfbench.reference.compare; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
            ).format(str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "repro_torch" not in out.stdout and "'repro'" not in out.stdout
    assert "'jax'" not in out.stdout


def test_harness_files_import_no_jax():
    for path in (REPO / "perfbench").rglob("*.py"):
        assert not imports_of(path) & set(harness.FORBIDDEN), path


def test_the_guard_names_what_it_finds(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "repro.models", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    found = harness.forbidden_modules()
    assert "jax.numpy" in found and "repro.models" in found
    assert "jaxtyping" not in found and "repro_torch" not in found
