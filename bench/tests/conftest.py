"""Fixtures of the benchmark's tests.

``card`` skips a test unless a CUDA card is present; it decides when the
test runs, never while the module is imported.  ``tiny_spec`` is a cell of
``BENCHMARK.json`` with its configuration and traffic cut to a size the CPU
runs in a second or two."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def cut_spec(workload: str) -> dict:
    """``workload``'s spec, cut to a tiny size."""
    from bench import harness

    spec = harness.cell_spec(workload)
    cfg, tr = spec["config"], spec["traffic"]
    if cfg["generator"] == "independent_terms":
        # a denser universe, so that tiny lists still meet
        cfg["lengths"] = [max(64, n // 512) for n in cfg["lengths"]]
        cfg["universe_bits"] = 20
    else:
        cfg["n"], cfg["planted"] = 20000, 200
    tr["batch"] = tr["warm"] = 16
    return spec


@pytest.fixture
def tiny_spec():
    return cut_spec
