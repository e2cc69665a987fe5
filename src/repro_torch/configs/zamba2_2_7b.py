"""zamba2-2.7b [arXiv:2411.15242; hf-verified]: Mamba2 + shared attn blocks.

54 Mamba2 blocks; one parameter-shared GQA attention block applied every 6
blocks.  O(1)-state decode => eligible for long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="ssm_hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
    sub_quadratic=True, tie_embeddings=True,
)
