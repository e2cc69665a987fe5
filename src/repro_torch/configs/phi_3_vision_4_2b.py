"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct; hf-verified].

phi3-mini backbone + CLIP frontend STUB: input_specs() supplies precomputed
(B, 576, 1024) patch embeddings, projected and prepended to the sequence.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064, rope_theta=1e4,
    frontend="patch", frontend_dim=1024, num_patches=576,
    tie_embeddings=False,
)
