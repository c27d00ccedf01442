"""Model family registry: maps ``ModelConfig.family`` to the model API.

Only the dense family is ported so far; the others raise, naming the
``ROADMAP.md`` item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import transformer
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Callable
    logits_fn: Callable
    init_cache: Callable
    # paged-native entry points: the cache's sequence leaves are the
    # serving arena's page pools read through a block table
    decode_step_paged: Callable
    prefill_chunk_paged: Callable


_DENSE = ModelApi(transformer.init, transformer.logits_fn,
                  transformer.init_cache, transformer.decode_step_paged,
                  transformer.prefill_chunk_paged)

_NOT_PORTED = {
    "moe": "ROADMAP.md Queue 1 item 8 (MoE)",
    "vlm": "ROADMAP.md Queue 1 item 9 (VLM and audio)",
    "audio": "ROADMAP.md Queue 1 item 9 (VLM and audio)",
    "ssm": "ROADMAP.md Queue 1 item 10 (SSM and hybrid)",
    "hybrid": "ROADMAP.md Queue 1 item 10 (SSM and hybrid)",
}


def family_api(family: str) -> ModelApi:
    if family == "dense":
        return _DENSE
    if family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {family!r} is not ported to repro_torch yet: "
            f"{_NOT_PORTED[family]}")
    raise KeyError(f"unknown model family {family!r}")


def model_api(cfg: ModelConfig) -> ModelApi:
    return family_api(cfg.family)
