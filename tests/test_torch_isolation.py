"""The port stands alone: ``src/repro_torch/`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, and its 2-D topology
(``repro_torch.exec.topology``) runs with both refused.

A subprocess installs a meta-path hook that refuses ``jax``, ``jaxlib``,
``repro`` and ``repro.*`` (but not ``repro_torch``) and imports every
module of the port and ``chip_smoke``; a static scan finds no such import
in any of their sources.  The dry run (``launch/dryrun.py``, with
``launch/op_analysis.py``) runs a cell with both refused.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("*_torch.py")))
BLOCKED = ("jax", "jaxlib", "repro")

PROBE = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "repro")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
try:
    import repro.core.hashing  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("the hook did not block the JAX package")
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (defines main(); runs nothing on import)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("\n".join(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    expected = {
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"}
    assert expected <= imported, expected - imported


TOPOLOGY_PROBE = r"""
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
from repro_torch.exec.topology import make_topology
from repro_torch.serve.search import SearchEngine

rng = np.random.default_rng(0)
shared = rng.choice(1 << 20, 300, replace=False).astype(np.uint32)
postings = {t: np.unique(np.concatenate(
    [shared, rng.choice(1 << 20, 3000, replace=False).astype(np.uint32)]))
    for t in range(3)}
eng = SearchEngine(postings, device="cpu", shard_min_g=4,
                   topology=make_topology(2, 2, devices=["cpu"] * 4))
got = eng.query([0, 1, 2])
want = np.intersect1d(np.intersect1d(postings[0], postings[1]), postings[2])
assert got.algorithm == "rangroupscan/mesh2d", got.algorithm
assert np.array_equal(got.doc_ids, want)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not loaded, loaded
print("TOPOLOGY_OK")
"""


def test_topology_runs_with_jax_and_repro_blocked():
    """``repro_torch.exec.topology`` imports, and a 2x2 layout over four
    logical CPU devices answers a query, with JAX and the JAX package
    refused."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", TOPOLOGY_PROBE],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "TOPOLOGY_OK" in proc.stdout


DRYRUN_PROBE = r"""
import json, pathlib, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
from repro_torch.launch import dryrun

out = sys.argv[1]
dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--out", out])
rec = json.loads((pathlib.Path(out) / "qwen3-1.7b__decode_32k__16x16.json")
                 .read_text())
assert rec["status"] == "ok" and rec["n_devices"] == 256, rec
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not loaded, loaded
print("DRYRUN_OK")
"""


def test_dry_run_runs_with_jax_and_repro_blocked(tmp_path):
    """``launch/dryrun.py`` runs a full-width cell on the meta device (no
    GPU) with JAX and the JAX package refused."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", DRYRUN_PROBE, str(tmp_path)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "DRYRUN_OK" in proc.stdout


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path.name} imports {bad}"
    text = path.read_text()
    for needle in ("import jax", "from repro.", "import repro.",
                   "from repro import"):
        assert needle not in text, needle
