"""Assigned-architecture configs (``--arch <id>``) + input shapes.

Every config cites its source model card / paper.  ``long_context_variant``
returns the explicitly-flagged sliding-window variant used for the
``long_500k`` shape on pure full-attention archs (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.models.config import (INPUT_SHAPES, SHAPES_BY_NAME, ModelConfig,
                                 ShapeSpec, reduced)

from . import (codeqwen1_5_7b, grok_1_314b, mamba2_2_7b, minicpm_2b,
               minitron_4b, mistral_large_123b, mixtral_8x7b, paligemma_3b,
               whisper_large_v3, zamba2_7b)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (mistral_large_123b, minitron_4b, minicpm_2b, grok_1_314b,
              whisper_large_v3, mixtral_8x7b, paligemma_3b, zamba2_7b,
              mamba2_2_7b, codeqwen1_5_7b)
}

ARCH_IDS: List[str] = list(ARCHS)

LONG_CONTEXT_WINDOW = 4096


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}") from None


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """SWA variant for long_500k on pure full-attention archs.  Natively
    sub-quadratic families (ssm/hybrid/native-SWA) are returned unchanged;
    full-attention archs get an explicit sliding window (this is a variant,
    not the paper model — recorded per-run in EXPERIMENTS.md)."""
    if cfg.sub_quadratic:
        return cfg
    return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)


def config_for_shape(arch: str, shape_name: str) -> ModelConfig:
    cfg = get_config(arch)
    if shape_name == "long_500k":
        cfg = long_context_variant(cfg)
    return cfg


__all__ = ["ARCHS", "ARCH_IDS", "INPUT_SHAPES", "SHAPES_BY_NAME",
           "get_config", "long_context_variant", "config_for_shape",
           "reduced", "ModelConfig", "ShapeSpec"]
