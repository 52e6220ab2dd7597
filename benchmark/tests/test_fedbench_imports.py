"""The import rule: nothing the harness runs loads JAX, jaxlib, flax or
the JAX package (top-level names compared whole, so flashe_tpu_torch
passes), and the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from tiny import REPO

BENCH = os.path.join(REPO, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "flashe_tpu"}


def _modules(sub):
    out = []
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in dirpath.split(os.sep) or "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)
                if "." in f[:-3]:  # a metric named with dots: by its path
                    out.append(rel)
                    continue
                mod = rel[:-3].replace(os.sep, ".")
                out.append(mod[:-9] if mod.endswith(".__init__") else mod)
    return sorted(out)


def _loaded_after(mods):
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {mods!r}:\n"
            "    if not m.endswith('.py'):\n"
            "        importlib.import_module(m)\n"
            "        continue\n"
            "    spec = importlib.util.spec_from_file_location('_m', m)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(p.stdout.split())


def test_the_harness_loads_no_jax():
    loaded = _loaded_after(_modules(""))
    assert "flashe_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(_modules("reference"))
    assert not loaded & (FORBIDDEN | {"flashe_tpu_torch"})


def test_the_reference_names_nothing_of_the_program():
    for mod in _modules("reference"):
        path = os.path.join(REPO, *mod.split(".")) + (
            ".py" if not mod.endswith("reference") else "/__init__.py")
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN | {"flashe_tpu_torch"}, (mod, n)
