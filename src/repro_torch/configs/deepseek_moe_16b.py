"""deepseek-moe-16b [arXiv:2401.06066; hf-verified]: fine-grained MoE.

2 shared + 64 routed experts, top-6, expert d_ff=1408; first layer dense
(d_ff=10944) as in the paper.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab=102400,
    n_experts=64, n_shared_experts=2, experts_per_token=6, moe_d_ff=1408,
    first_dense_layers=1, tie_embeddings=True,
)
