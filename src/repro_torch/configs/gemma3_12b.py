"""gemma3-12b [hf:google/gemma-3 family; unverified]: 5:1 local:global, 128k.

Sub-quadratic: 5 of 6 layers use a 1024-token sliding window, so the arch is
eligible for the long_500k decode shape (global layers decode O(S) per token).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144, qk_norm=True, rope_theta=1e6,
    sliding_window=1024, local_global_ratio=5, sub_quadratic=True,
    tie_embeddings=True,
)
