"""mixtral-8x7b [moe] — 8 experts top-2, native SWA [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, sliding window 4096.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    citation="arXiv:2401.04088 (Mixtral of Experts)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    epara_sensitivity="latency",
    epara_multi_gpu=True,
)
