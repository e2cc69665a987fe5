"""PyTorch + CUDA port of the fast set intersection system.

A second package beside the JAX one (``src/repro``), laid out the same way
(``core/``, ``kernels/``, ``exec/``, ``serve/``, ``data/``) so each module
sits where its counterpart does.  It imports ``torch`` and ``numpy`` only;
the offline stage (partitioning, hashing, images) stays host-side numpy and
the online stage runs eagerly on a ``torch.device``.  The two phases of the
online stage are hand-written CUDA kernels (``csrc/``); a CPU tensor takes
their plain PyTorch versions instead.

Every entry point takes ``device=`` and defaults to ``"cuda"``; the CPU is
used only when the caller asks for it.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
