"""The port stands alone: espnet_slurp_tpu_torch imports neither JAX/flax nor
anything of espnet_slurp_tpu (only the tests import both)."""
import pathlib
import re
import subprocess
import sys

import espnet_slurp_tpu_torch

PKG = pathlib.Path(espnet_slurp_tpu_torch.__file__).parent

# Counts only modules the port's imports add, so an interpreter that loads
# something at start-up cannot blame the port.
_PROBE = """
import importlib, pkgutil, sys
before = set(sys.modules)
import espnet_slurp_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "espnet_slurp_tpu"))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax_and_no_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        cwd=PKG.parent, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 20, proc.stdout
    assert bad == "[]", bad


def test_no_source_names_the_reference_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(espnet_slurp_tpu(?!_torch)\b|jax\b|flax\b)",
        re.M)
    offenders = [str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
