"""whisper-large-v3 [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356].

32L d_model=1280 20H (kv=20, MHA) d_ff=5120 vocab=51866.  The mel/conv
frontend is stubbed per the assignment: input_specs feeds 1500 frame
embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    citation="arXiv:2212.04356 (Whisper); large-v3 model card",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    encoder_len=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    activation="gelu_mlp",
    epara_sensitivity="frequency",  # streaming ASR = frame-continuous
    epara_multi_gpu=False,
)
