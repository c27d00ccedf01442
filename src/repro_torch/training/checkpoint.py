"""Checkpoints: parameter trees <-> ``.npz`` archives, in the reference's
format (``repro/training/checkpoint.py``).

Leaves are addressed by their tree path ("blocks/attn/wq") and the step by
"__step__", so a file written here is one the reference's ``restore``
reads, and restores are order-independent and may be partial.  numpy has
no bfloat16: bf16 leaves are written as float32, which holds every bf16
value exactly, and each restore casts back to the tree it fills.  A bf16
leaf the reference wrote (raw 2-byte records) is read by its bits.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from .tree import tree_leaves, tree_paths, tree_unflatten


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def save(path: str, tree, *, step: Optional[int] = None) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _array(v) for k, v in tree_paths(tree).items()}
    if step is not None:
        flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)
    return _npz(path)


def _tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:       # raw bf16 bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)


def restore(path: str, like) -> Any:
    """A tree of ``like``'s keys, shapes, dtypes and devices, filled from
    the checkpoint."""
    path = _npz(path)
    data = np.load(path)
    keys = list(tree_paths(like))
    missing = [k for k in keys if k not in data.files]
    if missing:
        raise KeyError(f"checkpoint {path} missing keys: {missing[:5]}...")
    return tree_unflatten(like, [_tensor(data[k], leaf) for k, leaf in
                                 zip(keys, tree_leaves(like))])


def restored_step(path: str) -> Optional[int]:
    data = np.load(_npz(path))
    return int(data["__step__"]) if "__step__" in data.files else None
