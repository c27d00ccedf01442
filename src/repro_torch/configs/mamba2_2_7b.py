"""mamba2-2.7b [ssm] — SSD, attention-free [arXiv:2405.21060].

64L d_model=2560, ssm_state=128, headdim=64 (=> 80 SSD heads), vocab=50280.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    citation="arXiv:2405.21060 (Mamba-2 / SSD)",
    num_layers=64,
    d_model=2560,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    epara_sensitivity="frequency",
    epara_multi_gpu=False,
)
