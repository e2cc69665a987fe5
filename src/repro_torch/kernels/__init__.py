"""Kernels of the online stage (phase 1, phase 2, the answers' compaction,
the suggest counts) and their plain versions.

``ops`` is the router callers use: a CUDA tensor goes to the hand-written
kernel (``bitmap_filter``, ``group_intersect``, ``compact``, ``count``;
sources in ``../csrc``), a CPU tensor to the plain PyTorch version in
``ref``.
"""
