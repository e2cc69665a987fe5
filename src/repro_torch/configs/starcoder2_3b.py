"""starcoder2-3b [arXiv:2402.19173; hf-verified]: dense GQA + RoPE, GeLU MLP."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab=49152, rope_theta=1e5, mlp_variant="gelu",
    tie_embeddings=True,
)
