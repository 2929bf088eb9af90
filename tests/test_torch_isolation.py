"""The port stands alone: `repro_torch`, its examples (`examples/torch_*.py`)
and `chip_smoke.py` import neither jax nor anything of the reference package
`repro`, so they run where jax is not installed."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# a torch subprocess runs on one thread, as this process does: the test
# command runs several workers on the cores
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
PORT = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + sorted((ROOT / "examples").glob("torch_*.py"))
           + [ROOT / "chip_smoke.py"])

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
sys.path.insert(0, {root!r})
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len([m for m in sys.modules if m.startswith("repro_torch")]), bad)
"""


def test_importing_the_port_loads_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD)
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL.format(root=str(ROOT))],
                         capture_output=True, text=True, env=env, timeout=120, check=True)
    n_modules, bad = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_reference_module(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


# the federation mesh's modules (sharding/, launch/mesh.py), each imported
# first in a fresh interpreter: torch.distributed and the port only
MESH_MODULES = ["repro_torch.sharding", "repro_torch.sharding.ctx", "repro_torch.sharding.specs",
                "repro_torch.sharding.fed", "repro_torch.launch.mesh"]
IMPORT_ONE = """
import importlib, sys
importlib.import_module({module!r})
print(sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro.")))
"""


@pytest.mark.parametrize("module", MESH_MODULES)
def test_mesh_module_loads_no_jax_and_no_reference_module(module):
    path = PORT.joinpath(*module.split(".")[1:])
    assert path.with_suffix(".py") in SOURCES or path / "__init__.py" in SOURCES
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD)
    out = subprocess.run([sys.executable, "-c", IMPORT_ONE.format(module=module)],
                         capture_output=True, text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
