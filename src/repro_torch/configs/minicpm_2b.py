"""minicpm-2b [dense] — WSD schedule, llama-like arch [arXiv:2404.06395].

40L d_model=2304 36H (GQA kv=36 = MHA) d_ff=5760 vocab=122753.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    citation="arXiv:2404.06395 (MiniCPM)",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    epara_sensitivity="frequency",   # HCI-style continuous requests (§4.3)
    epara_multi_gpu=False,
)
