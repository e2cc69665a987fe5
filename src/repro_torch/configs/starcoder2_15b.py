"""starcoder2-15b [arXiv:2402.19173; hf-verified]: dense GQA + RoPE, GeLU MLP."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152, rope_theta=1e5, mlp_variant="gelu",
    tie_embeddings=False,
)
