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


_NP_TO_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32, "float64": torch.float64}


def params_from_jax(np_tree, cfg: ModelConfig, device=None):
    """A nested dict of numpy arrays -> the same dict of torch tensors on
    ``device`` (the card unless ``"cpu"``).  Each leaf keeps the reference
    array's own dtype: most follow the config's weight dtype, but some are
    float32 whatever it is (Mamba-2's ``A_log``, ``dt_bias`` and ``D``).
    A floating leaf whose dtype did not survive the crossing raises."""
    dev = resolve_device(device)

    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, f"{path}/{k}") for k, v in node.items()}
        a = np.asarray(node)
        t = _tensor(a, dev)
        want = _NP_TO_TORCH.get(a.dtype.name)
        if t.dtype.is_floating_point and t.dtype != want:
            raise ValueError(f"{path} of {cfg.name!r}: reference dtype "
                             f"{a.dtype.name} became {t.dtype}")
        return t

    return convert(np_tree, "")
