"""The port stands alone: no file under ``src/repro_torch/`` imports
``jax`` or anything of the reference package ``repro``, and every module
imports in a process where ``jax`` cannot be imported."""
import ast
import pathlib
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_reference():
    seen = 0
    for path, _ in _modules():
        for name in _imported(ast.parse(path.read_text())):
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path.name} imports {name}"
            seen += 1
    assert seen > 0


def test_every_module_imports_without_jax():
    names = [name for _, name in _modules()]
    assert "repro_torch.core.rounds" in names
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "print(sorted(m for m, mod in sys.modules.items()\n"
            "             if mod is not None and m.split('.')[0]\n"
            "             in ('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(PKG.parent),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
