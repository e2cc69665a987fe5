"""xlstm-350m [arXiv:2405.04517; unverified]: sLSTM + mLSTM blocks.

24 blocks, every 4th an sLSTM (serial recurrence), rest mLSTM (parallel
chunked matrix-memory).  d_ff=0: blocks carry internal up/down projections.
Recurrent O(1)-state decode => eligible for long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="xlstm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab=50304, slstm_every=4,
    sub_quadratic=True, tie_embeddings=True,
)
