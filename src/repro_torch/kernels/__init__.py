"""Phase-1 / phase-2 kernels of the online stage and their plain versions.

``ops`` is the router callers use: a CUDA tensor goes to the hand-written
kernel (``bitmap_filter``, ``group_intersect``; sources in ``../csrc``), a
CPU tensor to the plain PyTorch version in ``ref``.
"""
