"""paligemma-3b [vlm] — SigLIP + gemma [arXiv:2407.07726].

18L d_model=2048 8H (MQA kv=1, head_dim 256) d_ff=16384 vocab=257216.
SigLIP tower + projector are a STUB: input_specs feeds 256 patch
embeddings; this config is the gemma-2b language backbone with prefix-LM
masking over the image prefix.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    citation="arXiv:2407.07726 (PaliGemma)",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    activation="geglu",
    tie_embeddings=True,
    prefix_len=256,
    epara_sensitivity="latency",
    epara_multi_gpu=False,
)
