"""Model family registry: maps ``ModelConfig.family`` to the model API.

The dense, MoE, SSM and audio (encoder-decoder) families are ported for
serving (every dense-cache and paged-native entry point), the dense family
also for training; the others raise, naming the ``ROADMAP.md`` item that
ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from . import encdec, moe, ssm, transformer
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
    # the training forward, (params, cfg, batch, *, train) -> (hidden,
    # aux loss); ``None`` where not ported (every family but the dense
    # one: ROADMAP.md Queue 1 item 12)
    forward_hidden: Optional[Callable] = None


_FAMILIES = {
    "dense": ModelApi(transformer.init, transformer.logits_fn,
                      transformer.init_cache, transformer.prefill,
                      transformer.prefill_chunk, transformer.decode_step,
                      decode_step_paged=transformer.decode_step_paged,
                      prefill_chunk_paged=transformer.prefill_chunk_paged,
                      verify_step_paged=transformer.verify_step_paged,
                      forward_hidden=transformer.forward_hidden),
    "moe": ModelApi(moe.init, moe.logits_fn, moe.init_cache, moe.prefill,
                    moe.prefill_chunk, moe.decode_step,
                    decode_step_paged=moe.decode_step_paged,
                    prefill_chunk_paged=moe.prefill_chunk_paged,
                    verify_step_paged=moe.verify_step_paged),
    "ssm": ModelApi(ssm.init, ssm.logits_fn, ssm.init_cache, ssm.prefill,
                    ssm.prefill_chunk, ssm.decode_step),
    "audio": ModelApi(encdec.init, encdec.logits_fn, encdec.init_cache,
                      encdec.prefill, encdec.prefill_chunk,
                      encdec.decode_step,
                      decode_step_paged=encdec.decode_step_paged,
                      prefill_chunk_paged=encdec.prefill_chunk_paged),
}

_NOT_PORTED = {
    "vlm": "ROADMAP.md Queue 1 item 9 (VLM)",
    "hybrid": "ROADMAP.md Queue 1 item 10 (hybrid)",
}


def family_api(family: str) -> ModelApi:
    if family in _FAMILIES:
        return _FAMILIES[family]
    if family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {family!r} is not ported to repro_torch yet: "
            f"{_NOT_PORTED[family]}")
    raise KeyError(f"unknown model family {family!r}")


def model_api(cfg: ModelConfig) -> ModelApi:
    return family_api(cfg.family)
