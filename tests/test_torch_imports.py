"""The port imports neither JAX nor anything of the JAX package ``repro``.

The source scan walks every node of each file, so an import inside a
function (``from repro.serving import ...`` at any indentation) counts as
much as one at the top, and so does a literal module name handed to
``importlib.import_module`` or ``__import__``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("package", ["kernels", "models", "configs", "serve",
                                     "train", "launch", "cluster",
                                     "calibrate", "core", "pipeline",
                                     "runtime", "serving", "optim",
                                     "checkpoint", "data", "obs",
                                     "examples", "parallel"])
def test_subpackage_is_covered(package):
    """The subprocess below imports every module of each subpackage."""
    mods = [m for m in _modules() if m.startswith(f"repro_torch.{package}")]
    assert f"repro_torch.{package}" in mods and len(mods) > 1, mods


def test_every_module_imports_without_jax_or_repro():
    code = ("import sys, importlib\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _bad_imports(source: str, filename: str = "<source>") -> list:
    """Every forbidden module ``source`` imports, at any depth."""
    bad = []
    for node in ast.walk(ast.parse(source, filename=filename)):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and _forbidden(node.args[0].value) \
                and getattr(node.func, "attr",
                            getattr(node.func, "id", None)) in (
                                "import_module", "__import__"):
            bad.append(node.args[0].value)
    return bad


@pytest.mark.parametrize("source,found", [
    ("def f():\n    from repro.serving.fabric import run_serving\n",
     ["repro.serving.fabric"]),
    ("class A:\n    def f(self):\n        if True:\n"
     "            import jax.numpy as jnp\n", ["jax.numpy"]),
    ("import importlib\nm = importlib.import_module('repro.obs')\n",
     ["repro.obs"]),
    ("m = __import__('jaxlib')\n", ["jaxlib"]),
    ("def f():\n    from repro_torch.obs import explain_miss\n"
     "    from . import spans\n", []),
])
def test_scan_finds_imports_at_any_depth(source, found):
    assert _bad_imports(source) == found


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_repro_import(path):
    bad = _bad_imports(path.read_text(), str(path))
    assert not bad, f"{path}: imports {bad}"
