"""Analytic per-device HBM traffic model (the roofline memory term; the
port of the reference package's ``roofline/analytic.py``).

Why analytic: the port runs its ops eagerly and unfused, so the bytes of
the ops a step dispatches (``op_cost``) count every intermediate's
round trip, while the attention kernels keep their score tiles on chip.
FLOPs come from ``op_cost``; bytes from this model of what a step
streams from and to HBM.  The dispatched ops' bytes are recorded beside
it as a cross-check.

The flash K/V re-read factor follows the port's own flash forward: one
pass over K and V a q tile of ``FLASH_BLOCK`` rows
(``kernels/csrc/flash_attention.cu``, ``kBlockM``), where the reference
streams a 512-row block.

All quantities are PER DEVICE per executed step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig, ShapeSpec

BF16 = 2
F32 = 4
FLASH_BLOCK = 64           # the flash forward's q tile: kv re-read factor = Lq/blk


@dataclasses.dataclass
class TrafficBreakdown:
    weights: float = 0.0       # streamed weight reads (gathered copies)
    optimizer: float = 0.0     # grads + moments r/w
    activations: float = 0.0   # saved/rematted layer carries
    kv_rereads: float = 0.0    # flash attention K/V streaming
    cache: float = 0.0         # decode cache read + token write
    logits: float = 0.0        # lm-head + loss traffic
    embeds: float = 0.0        # embedding gathers + stub inputs

    @property
    def total(self) -> float:
        return (self.weights + self.optimizer + self.activations
                + self.kv_rereads + self.cache + self.logits + self.embeds)

    def to_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in
                ("weights", "optimizer", "activations", "kv_rereads",
                 "cache", "logits", "embeds")} | {"total": self.total}


def _vocab_shard(cfg: ModelConfig, model_ax: int) -> int:
    return model_ax if cfg.vocab_size % model_ax == 0 else 1


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // max(1, cfg.attn_every)
    if cfg.family == "audio":
        return cfg.num_layers + cfg.encoder_layers   # + cross attn ~ self
    return cfg.num_layers


def traffic(cfg: ModelConfig, shape: ShapeSpec, *, data_ax: int,
            model_ax: int, pod_ax: int = 1, microbatches: int = 1,
            optimizer: str = "adamw", loss_chunk: int = 512,
            fsdp: bool = True, serve_2d_tp: bool = False,
            flash_block: int = FLASH_BLOCK) -> TrafficBreakdown:
    chips = data_ax * model_ax * pod_ax
    P = cfg.param_count()
    N_layers = max(1, cfg.num_layers)
    d = cfg.d_model
    tb = TrafficBreakdown()

    # tokens this device processes per step
    batch_shards = data_ax * pod_ax if shape.global_batch % (
        data_ax * pod_ax) == 0 else 1
    B_dev = shape.global_batch / batch_shards

    if shape.kind == "train":
        passes = 3.0  # fwd + remat-recompute + bwd weight reads
        # each pass streams the model-axis shard of every weight (gathered
        # over data when fsdp), once per microbatch
        tb.weights = passes * microbatches * P * BF16 / model_ax
        opt_bytes = {"adamw": (4 + 4) + (8 + 8),       # grad r/w + m,v r/w
                     "adafactor": (4 + 4) + 2.2}[optimizer]
        tb.optimizer = P * opt_bytes / chips
        toks_dev = shape.tokens / batch_shards
        # saved carry per layer (sharded over model too via the constraint)
        tb.activations = 4.0 * toks_dev * d * BF16 * N_layers / model_ax
        # flash kv re-reads: per attn layer, K+V streamed once per q block
        nq = max(1, shape.seq_len // flash_block)
        window = cfg.sliding_window
        lk_eff = min(shape.seq_len, (window + flash_block)) if window \
            else shape.seq_len
        kv_bytes = (B_dev * lk_eff * cfg.num_kv_heads * cfg.head_dim
                    * 2 * BF16)
        rereads_per_block = min(nq, max(
            1, lk_eff // flash_block)) if window else nq
        tb.kv_rereads = (_attn_layers(cfg) / max(1, N_layers) * N_layers
                         * kv_bytes * rereads_per_block * 3.0  # fwd+rec+bwd
                         / model_ax)
        vshard = _vocab_shard(cfg, model_ax)
        tb.logits = 3.0 * toks_dev * cfg.vocab_size * F32 / vshard
        tb.embeds = 2.0 * toks_dev * d * BF16
    elif shape.kind == "prefill":
        tb.weights = P * BF16 / model_ax
        toks_dev = shape.tokens / batch_shards
        tb.activations = toks_dev * d * BF16 * N_layers / model_ax
        nq = max(1, shape.seq_len // flash_block)
        window = cfg.sliding_window
        lk_eff = min(shape.seq_len, window + flash_block) if window \
            else shape.seq_len
        kv_bytes = (B_dev * lk_eff * cfg.num_kv_heads * cfg.head_dim
                    * 2 * BF16)
        rereads = max(1, lk_eff // flash_block) if window else nq
        tb.kv_rereads = _attn_layers(cfg) * kv_bytes * rereads / model_ax
        # cache write
        tb.cache = _attn_layers(cfg) * kv_bytes / model_ax
        vshard = _vocab_shard(cfg, model_ax)
        tb.logits = (shape.global_batch / batch_shards) * cfg.vocab_size \
            * F32 / vshard
        tb.embeds = toks_dev * d * BF16
    else:  # decode: ONE token against a seq_len-deep cache
        if serve_2d_tp:
            # weights stay shard-resident (no FSDP gather): each chip
            # streams only its 1/chips shard; batch replicated
            tb.weights = P * BF16 / chips
            B_dev = shape.global_batch
        else:
            tb.weights = P * BF16 / model_ax    # gathered copy per step
        window = cfg.sliding_window
        S = min(shape.seq_len, window) if window else shape.seq_len
        if cfg.family in ("ssm", "hybrid"):
            ssm_state = (cfg.num_layers * B_dev * cfg.ssm_nheads
                         * cfg.ssm_headdim * cfg.ssm_state * F32)
            tb.cache += 2.0 * ssm_state      # read + write
        kv_bytes = (B_dev * S * cfg.num_kv_heads * cfg.head_dim * 2 * BF16)
        cache_shard = (model_ax * data_ax * pod_ax) if serve_2d_tp \
            else model_ax
        tb.cache += _attn_layers(cfg) * kv_bytes / cache_shard
        if cfg.family == "audio":
            xkv = (B_dev * cfg.encoder_len * cfg.num_kv_heads * cfg.head_dim
                   * 2 * BF16)
            tb.cache += cfg.num_layers * xkv / model_ax
        vshard = _vocab_shard(cfg, model_ax)
        tb.logits = B_dev * cfg.vocab_size * F32 / vshard
        tb.embeds = B_dev * d * BF16
    return tb
