"""The port stands alone: importing all of it loads no jax and no ``repro``."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch

ROOT = Path(__file__).resolve().parents[1]

CHECK = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, {root!r})
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(names))
"""


def _modules():
    return ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", CHECK.format(root=str(ROOT))],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == len(_modules())


def test_no_source_of_the_port_names_jax_or_repro():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, line)


EXAMPLE = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("example", {path!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
"""


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_train_lm",
                                  "torch_serve_batched",
                                  "torch_resilient_training"])
def test_importing_a_port_example_loads_no_jax_and_no_repro(name):
    path = ROOT / "examples" / f"{name}.py"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c",
                           EXAMPLE.format(path=str(path))],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    for line in path.read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            assert words[1].split(".")[0] not in ("jax", "jaxlib", "repro")


SCRIPT = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("mesh_smoke", {path!r})
module = importlib.util.module_from_spec(spec)
sys.modules["mesh_smoke"] = module
spec.loader.exec_module(module)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
"""


def test_mesh_smoke_loads_no_jax_and_no_repro():
    """``scripts/mesh_smoke.py``, the four-card script, imports the port and
    ``chip_smoke`` only."""
    path = ROOT / "scripts" / "mesh_smoke.py"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c",
                           SCRIPT.format(path=str(path))],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    for line in path.read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            assert words[1].split(".")[0] not in ("jax", "jaxlib", "repro")
