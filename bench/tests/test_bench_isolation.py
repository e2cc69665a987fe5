"""What the benchmark may load: the reference imports with JAX, the JAX
package and the port all blocked, and no file under bench/ imports JAX or
the JAX package, compared by whole top-level module name."""
import ast
import pathlib
import subprocess
import sys
import textwrap

from bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

BLOCKED_IMPORT = textwrap.dedent("""
    import sys
    BLOCKED = {"jax", "jaxlib", "flax", "repro", "repro_torch"}

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[1])
    import bench.reference as ref
    import torch
    got = ref.intersect([torch.tensor([1, 3, 5, 7]), torch.tensor([3, 4, 7])])
    assert got.tolist() == [3, 7], got
    loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ok")
""")


def test_reference_imports_with_jax_and_both_packages_blocked():
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def imported_top_levels(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_under_bench_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "bench").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        bad = set(imported_top_levels(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_port_is_not_the_jax_package():
    # repro_torch shares a prefix with repro; the check compares whole names
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert not [n for n in harness.forbidden_modules()
                if n.endswith("_fake")]
    monkeypatch.setitem(sys.modules, "jax.fake", object())
    assert "jax.fake" in harness.forbidden_modules()
