"""kimi-k2-1t-a32b [arXiv:2501 Kimi K2; paper-table, unverified].

Trillion-parameter MoE: 384 routed experts top-8 + 1 shared, expert
d_ff=2048 (fine-grained), 61 layers at d_model=7168.  ~1.03T total params,
~32B active per token.  Requires full (pod x data x model) parameter
sharding — see EXPERIMENTS.md §Dry-run for the memory analysis.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=18432, vocab=163840,
    n_experts=384, n_shared_experts=1, experts_per_token=8, moe_d_ff=2048,
    first_dense_layers=1, tie_embeddings=True,
    # 1T params: bf16 master + bf16 optimizer state (6 B/param total) is the
    # only way 512 x 16 GiB chips hold the training state — see EXPERIMENTS.
    param_dtype="bfloat16",
)
