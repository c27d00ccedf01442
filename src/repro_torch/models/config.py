"""Model configuration dataclasses shared by the model zoo and configs/.

A field-for-field copy of the reference package's ``models/config.py``;
only ``compute_dtype``/``weight_dtype`` differ, returning torch dtypes.

Every assigned architecture instantiates a :class:`ModelConfig`.  The config
is deliberately flat — one dataclass covers dense / MoE / SSM / hybrid /
enc-dec / VLM families, with family-specific fields defaulting to inert
values.  ``family`` selects the forward implementation in
``repro_torch.models.registry``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identification
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    citation: str = ""

    # transformer backbone
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    qkv_bias: bool = False          # qwen1.5 style
    fused_projections: bool = False  # fused QKV + gate|up matmuls: 1 bwd
    #                                  dx all-reduce instead of 3 (resp. 2)
    #                                  under tensor parallelism (§Perf)
    tie_embeddings: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    activation: str = "swiglu"       # swiglu | geglu | gelu_mlp
    sliding_window: Optional[int] = None   # native SWA (mixtral)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # hybrid (zamba2): a shared attention block applied every `attn_every`
    # SSM layers, consuming concat(h, h0) like the Zamba family.
    attn_every: int = 0

    # enc-dec (whisper): number of encoder layers + encoder memory length.
    encoder_layers: int = 0
    encoder_len: int = 0             # 1500 audio frames for whisper

    # vlm (paligemma): number of image-prefix tokens fed as embeddings.
    prefix_len: int = 0

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # EPARA control-plane category hints (latency|frequency, gpus estimate)
    epara_sensitivity: str = "latency"
    epara_multi_gpu: bool = False

    # ------------------------------------------------------------------
    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def weight_dtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Whether long-context decode is natively sub-quadratic-safe
        (bounded attention working set): SSMs, hybrids with windowed shared
        attention, and SWA models."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, L, V = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        hd = self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d

        def attn_params(dm):
            return dm * (nq * hd) + 2 * dm * (nkv * hd) + (nq * hd) * dm

        def mlp_params(dm, ff):
            if self.activation in ("swiglu", "geglu"):
                return 3 * dm * ff
            return 2 * dm * ff

        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn_params(d) + mlp_params(d, f) + 2 * d
            total += L * per_layer
            if self.family == "audio":
                # decoder cross-attention + encoder stack
                total += L * attn_params(d)
                enc_per = attn_params(d) + mlp_params(d, f) + 2 * d
                total += self.encoder_layers * enc_per
        elif self.family == "moe":
            per_layer = attn_params(d) + 2 * d
            per_layer += self.num_experts * mlp_params(d, f)
            per_layer += d * self.num_experts  # router
            total += L * per_layer
        elif self.family == "ssm":
            total += L * self._ssm_block_params()
        elif self.family == "hybrid":
            total += L * self._ssm_block_params()
            # one shared attention+mlp block over concat(h, h0)
            total += (2 * d) * (nq * hd) + 2 * (2 * d) * (nkv * hd) \
                + (nq * hd) * d + mlp_params(d, f)
        return total

    def _ssm_block_params(self) -> int:
        d, di, N = self.d_model, self.d_inner, self.ssm_state
        H, G, k = self.ssm_nheads, self.ssm_ngroups, self.ssm_conv_kernel
        in_proj = d * (2 * di + 2 * G * N + H)
        conv = (di + 2 * G * N) * k
        out_proj = di * d
        extras = 2 * H + di + d  # A_log, D, gate-norm, rmsnorm
        return in_proj + conv + out_proj + extras

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE counts top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        total = self.param_count()
        inactive = (self.num_experts - self.experts_per_token) * 3 * d * f * L
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

INPUT_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family (2 layers, d_model<=256,
    <=4 experts) used by per-arch smoke tests on CPU."""
    small = dict(
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=min(4, cfg.num_kv_heads) or 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.family == "moe":
        small.update(num_experts=min(4, cfg.num_experts), experts_per_token=2)
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
    if cfg.family == "hybrid":
        small.update(attn_every=2)
    if cfg.family == "audio":
        small.update(encoder_layers=2, encoder_len=64)
    if cfg.family == "vlm":
        small.update(prefix_len=16)
    if cfg.sliding_window is not None:
        small.update(sliding_window=64)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
