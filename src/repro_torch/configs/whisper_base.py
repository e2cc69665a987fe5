"""whisper-base [arXiv:2212.04356; unverified]: enc-dec; conv frontend STUB.

input_specs() supplies precomputed (B, 1500, 80) frame embeddings; the model
projects them to d_model (the conv1d+mel pipeline is out of scope per the
assignment).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab=51865, mlp_variant="gelu",
    frontend="audio", frontend_dim=80, encoder_seq=1500,
    tie_embeddings=True,
)
