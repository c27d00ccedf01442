"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention [arXiv:2411.15242].

81L d_model=3584 32H (kv=32) d_ff=14336, ssm_state=64.  One shared
attention+MLP block over concat(h, h0) applied every 6 mamba layers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    citation="arXiv:2411.15242 (Zamba2)",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    attn_every=6,
    epara_sensitivity="frequency",
    epara_multi_gpu=False,
)
