"""Carry the reference package's parameters over to the port.

The caller flattens the reference tree to numpy first
(``jax.tree.map(np.asarray, params)``), so this module never imports JAX.
Key paths and layouts stay as they are (stacked layer axis, ``(in, out)``
weights), so the port's functions read the result directly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                      # writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_tree, cfg: ModelConfig, device=None):
    """A nested dict of numpy arrays -> the same dict of torch tensors on
    ``device`` (the card unless ``"cpu"``).  Checks that every leaf has the
    config's weight dtype."""
    dev = resolve_device(device)

    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, f"{path}/{k}") for k, v in node.items()}
        t = _tensor(np.asarray(node), dev)
        if t.dtype != cfg.weight_dtype:
            raise ValueError(f"{path}: dtype {t.dtype}, config "
                             f"{cfg.name!r} wants {cfg.weight_dtype}")
        return t

    return convert(np_tree, "")
