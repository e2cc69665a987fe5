"""Build and bind the CUDA kernels: ``nvcc`` into one shared library with a
plain C interface, loaded with ``ctypes``.

The library is built on first use, never at import, from the sources in
``src/repro_torch/csrc/``, into ``build/kernels/`` at the repository root.
Its file name carries a hash of the sources and flags, so a changed source
builds a new library and an unchanged one is loaded as it is.  Each source
compiles in its own ``nvcc`` process, all started together, and the objects
are then linked; the link writes a temporary file that is renamed into
place, so a half-written library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import List, Optional

__all__ = ["build_library", "library", "check", "sources", "BUILD_DIR"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
# src/repro_torch/kernels/_build.py -> repository root
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas registers / shared memory / spills) and
# how long it took; empty when the library was already built
build_log = ""
build_seconds = 0.0


def sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit that torch.utils.cpp_extension finds."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); cannot build kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library() -> pathlib.Path:
    """Path of the built library, building it first if it is missing."""
    global build_log, build_seconds
    out = BUILD_DIR / f"libreprotorch-{_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}-{threading.get_ident()}"
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}-{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    try:
        for src, proc, log in zip(sources(), procs, logs):
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        tmp = out.with_name(f"{out.name}.{tag}.tmp")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_log = "".join(logs)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's ``argtypes``/``restype`` set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.repro_bitmap_filter.argtypes = [vp, vp, i64, i32, i64, i32, i32, vp]
            lib.repro_bitmap_filter.restype = i32
            lib.repro_group_match.argtypes = [vp, vp, vp, i64, i32, i32, vp]
            lib.repro_group_match.restype = i32
            lib.repro_pair_count.argtypes = [vp, vp, i64, i32, i32, i32, i32,
                                             i32, vp]
            lib.repro_pair_count.restype = i32
            lib.repro_compact_rows_scratch.argtypes = [i64, i64]
            lib.repro_compact_rows_scratch.restype = i64
            lib.repro_compact_rows.argtypes = [vp, vp, vp, vp, vp, i64, i64, vp]
            lib.repro_compact_rows.restype = i32
            lib.repro_cuda_error_string.argtypes = [i32]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
