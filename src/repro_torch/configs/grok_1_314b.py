"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    citation="hf:xai-org/grok-1",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_token=2,
    epara_sensitivity="latency",
    epara_multi_gpu=True,
)
