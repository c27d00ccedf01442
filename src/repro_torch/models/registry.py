"""Model family registry: maps ``ModelConfig.family`` to the model API.

Every family is ported for serving and for training: the dense, MoE,
SSM, hybrid, audio (encoder-decoder) and VLM families, each with every
dense-cache and paged-native entry point it has in the reference and its
training forward ``forward_hidden``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from . import encdec, hybrid, moe, ssm, transformer, vlm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Callable
    logits_fn: Callable
    init_cache: Callable
    # dense-cache entry points: the one-shot prefill, which builds a new
    # cache, and the chunk and decode steps over a dense cache (the sync
    # and dense engines' own, the arena's gathered view, or per-slot state)
    prefill: Callable
    prefill_chunk: Callable
    decode_step: Callable
    # the training forward, (params, cfg, batch, *, train) -> (hidden,
    # aux loss)
    forward_hidden: Callable
    # paged-native entry points: the cache's sequence leaves are the
    # serving arena's page pools read through a block table; ``None`` for
    # pure-SSM families, whose cache is all per-slot state
    decode_step_paged: Optional[Callable] = None
    prefill_chunk_paged: Optional[Callable] = None
    # speculative decoding's verify: score T = k+1 fed tokens against the
    # page pools in one pass, logits for all T positions (B, T, V), with
    # per-slot (B,) chunk lengths (0 = the slot is not speculating).
    # ``None`` for families without a paged-native chunk body: the serving
    # engine's speculation gate
    verify_step_paged: Optional[Callable] = None
    # the head-sharded steps (``launch/steps.py`` ``ShardedPagedStep``):
    # the decode and chunk steps over a list of ``transformer.Shard``s,
    # their arguments one entry a shard, partial sums reduced by a mesh
    # (every family registers them)
    decode_step_paged_tp: Optional[Callable] = None
    prefill_chunk_paged_tp: Optional[Callable] = None
    # the head-sharded verify (the dense and MoE families: speculation),
    # the dense decode and chunk steps over each shard's dense view or
    # window ring (every family with attention: the dense-view oracle and
    # ring layouts), and the one-shot prefill that returns each shard's
    # cache (every family), under ``ShardedPagedStep``
    verify_step_paged_tp: Optional[Callable] = None
    decode_step_tp: Optional[Callable] = None
    prefill_chunk_tp: Optional[Callable] = None
    prefill_tp: Optional[Callable] = None


_FAMILIES = {
    "dense": ModelApi(transformer.init, transformer.logits_fn,
                      transformer.init_cache, transformer.prefill,
                      transformer.prefill_chunk, transformer.decode_step,
                      decode_step_paged=transformer.decode_step_paged,
                      prefill_chunk_paged=transformer.prefill_chunk_paged,
                      verify_step_paged=transformer.verify_step_paged,
                      forward_hidden=transformer.forward_hidden,
                      decode_step_paged_tp=transformer.decode_step_paged_tp,
                      prefill_chunk_paged_tp=(
                          transformer.prefill_chunk_paged_tp),
                      verify_step_paged_tp=transformer.verify_step_paged_tp,
                      decode_step_tp=transformer.decode_step_tp,
                      prefill_chunk_tp=transformer.prefill_chunk_tp,
                      prefill_tp=transformer.prefill_tp),
    "moe": ModelApi(moe.init, moe.logits_fn, moe.init_cache, moe.prefill,
                    moe.prefill_chunk, moe.decode_step,
                    decode_step_paged=moe.decode_step_paged,
                    prefill_chunk_paged=moe.prefill_chunk_paged,
                    verify_step_paged=moe.verify_step_paged,
                    forward_hidden=moe.forward_hidden,
                    decode_step_paged_tp=moe.decode_step_paged_tp,
                    prefill_chunk_paged_tp=moe.prefill_chunk_paged_tp,
                    verify_step_paged_tp=moe.verify_step_paged_tp,
                    decode_step_tp=moe.decode_step_tp,
                    prefill_chunk_tp=moe.prefill_chunk_tp,
                    prefill_tp=moe.prefill_tp),
    "ssm": ModelApi(ssm.init, ssm.logits_fn, ssm.init_cache, ssm.prefill,
                    ssm.prefill_chunk, ssm.decode_step,
                    forward_hidden=ssm.forward_hidden,
                    decode_step_paged_tp=ssm.decode_step_paged_tp,
                    prefill_chunk_paged_tp=ssm.prefill_chunk_paged_tp,
                    prefill_tp=ssm.prefill_tp),
    "hybrid": ModelApi(hybrid.init, hybrid.logits_fn, hybrid.init_cache,
                       hybrid.prefill, hybrid.prefill_chunk,
                       hybrid.decode_step,
                       decode_step_paged=hybrid.decode_step_paged,
                       prefill_chunk_paged=hybrid.prefill_chunk_paged,
                       forward_hidden=hybrid.forward_hidden,
                       decode_step_paged_tp=hybrid.decode_step_paged_tp,
                       prefill_chunk_paged_tp=hybrid.prefill_chunk_paged_tp,
                       decode_step_tp=hybrid.decode_step_tp,
                       prefill_chunk_tp=hybrid.prefill_chunk_tp,
                       prefill_tp=hybrid.prefill_tp),
    "audio": ModelApi(encdec.init, encdec.logits_fn, encdec.init_cache,
                      encdec.prefill, encdec.prefill_chunk,
                      encdec.decode_step,
                      decode_step_paged=encdec.decode_step_paged,
                      prefill_chunk_paged=encdec.prefill_chunk_paged,
                      forward_hidden=encdec.forward_hidden,
                      decode_step_paged_tp=encdec.decode_step_paged_tp,
                      prefill_chunk_paged_tp=encdec.prefill_chunk_paged_tp,
                      decode_step_tp=encdec.decode_step_tp,
                      prefill_chunk_tp=encdec.prefill_chunk_tp,
                      prefill_tp=encdec.prefill_tp),
    "vlm": ModelApi(vlm.init, vlm.logits_fn, vlm.init_cache, vlm.prefill,
                    vlm.prefill_chunk, vlm.decode_step,
                    decode_step_paged=vlm.decode_step_paged,
                    prefill_chunk_paged=vlm.prefill_chunk_paged,
                    forward_hidden=vlm.forward_hidden,
                    decode_step_paged_tp=vlm.decode_step_paged_tp,
                    prefill_chunk_paged_tp=vlm.prefill_chunk_paged_tp,
                    decode_step_tp=vlm.decode_step_tp,
                    prefill_chunk_tp=vlm.prefill_chunk_tp,
                    prefill_tp=vlm.prefill_tp),
}

def family_api(family: str) -> ModelApi:
    if family in _FAMILIES:
        return _FAMILIES[family]
    raise KeyError(f"unknown model family {family!r}")


def model_api(cfg: ModelConfig) -> ModelApi:
    return family_api(cfg.family)
