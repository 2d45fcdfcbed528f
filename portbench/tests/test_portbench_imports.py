"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``unikmer_tpu_torch`` is not ``unikmer_tpu``."""

import ast
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "unikmer_tpu"}
SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


def top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    assert SOURCES
    for path in SOURCES:
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    ref = sorted((ROOT / "portbench" / "reference").rglob("*.py"))
    assert ref
    for path in ref:
        names = top_level_imports(path)
        assert not names & {"unikmer_tpu_torch", "portbench"}, path
        assert names <= {"__future__", "numpy", "torch"}, (path, names)


def test_a_dry_run_loads_no_jax():
    code = (
        "import os, sys; os.environ['UNIKMER_TPU_TORCH_DEVICE'] = 'cpu'\n"
        f"sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, "
        f"{str(ROOT / 'portbench' / 'tests')!r})\n"
        "from conftest import SMALL, SMALL_MIX\n"
        "from portbench.cell import run_cell, forbidden_modules\n"
        "for w in sorted(SMALL_MIX):\n"
        "    r = run_cell(w, 5, 2.0, True, threads=2, sizes=SMALL,\n"
        "                 mix_keys=SMALL_MIX[w])\n"
        "    assert r['correct'], r\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded, found = p.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert not set(eval(loaded)) & FORBIDDEN
    assert "unikmer_tpu_torch" in eval(loaded)
