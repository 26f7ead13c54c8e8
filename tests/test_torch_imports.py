"""The port imports neither JAX nor anything of the JAX package ``repro``.

Every module of the JAX package has its counterpart in the port
(``launch/hloparse.py``'s is ``launch/commcount.py``).  The dry run, its
collective counter and the ``bigdata_apps`` example with its
``paper_figs`` import no ``benchmarks`` either, and the dry run leaves
``XLA_FLAGS`` alone.

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


# the port's counterpart of a reference module that has another name
RENAMED = {"launch/hloparse.py": "launch/commcount.py"}


def test_every_reference_module_has_a_counterpart():
    ref = ROOT / "src" / "repro"
    missing = []
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        if not (PORT / RENAMED.get(rel, rel)).exists():
            missing.append(rel)
    assert not missing, missing


@pytest.mark.parametrize("module", ["repro_torch.launch.dryrun",
                                    "repro_torch.launch.commcount",
                                    "repro_torch.examples.paper_figs",
                                    "repro_torch.examples.bigdata_apps"])
def test_module_imports_no_benchmarks_and_sets_no_xla_flags(module):
    code = ("import importlib, os, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
            "print(bad, os.environ.get('XLA_FLAGS'))\n"
            "sys.exit(1 if bad or 'XLA_FLAGS' in os.environ else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)
                                  and n.module]
    assert not [n for n in names if n.split(".")[0] == "benchmarks"]
