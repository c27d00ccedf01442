"""Activation-sharding hook.

Model forwards call ``constrain_activation`` on scan carries at block
boundaries.  Outside a mesh deployment (CPU tests, examples) it is the
identity; the launcher installs a ``with_sharding_constraint`` closure so
remat-scan carries stay sharded (batch on the replica axes, d_model on
``model``) instead of ballooning to replicated (B, L, d) per layer — see
EXPERIMENTS.md §Perf.
"""
from __future__ import annotations

from typing import Callable, Optional

_FN: list = [None]


def set_activation_fn(fn: Optional[Callable]) -> None:
    _FN[0] = fn


def constrain_activation(x):
    fn = _FN[0]
    return x if fn is None else fn(x)
