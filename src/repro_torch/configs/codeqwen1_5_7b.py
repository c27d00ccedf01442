"""codeqwen1.5-7b [dense] — qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (kv=32, MHA) d_ff=13440 vocab=92416, qkv bias.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    citation="hf:Qwen/CodeQwen1.5-7B",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    epara_sensitivity="latency",
    epara_multi_gpu=False,
)
