"""Run one cell of the port's benchmark on this machine's CUDA card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the set-up's parts and the checked
numbers on standard error and, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
with ``--trace 1`` ``breakdown``) and ``checks``.  Exits non-zero with no
result when the cell's cards are missing or JAX got loaded.
"""
import time

STARTED_AT = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the script's own directory would shadow modules by bench's file names
sys.path[:] = [p for p in sys.path
               if pathlib.Path(p or ".").resolve() != ROOT / "bench"]
# the program's kernel caches stay in fixed directories of the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                 ("TRITON_CACHE_DIR", "build/triton")):
    os.environ[var] = str(ROOT / sub)
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started_at=STARTED_AT))
