"""Meshes and the sharding rules for every (arch x shape) step, over the
port's parameter trees (the port of the reference package's
``launch/mesh.py``).

A mesh is axis names, a shape and a row-major list of ``torch.device``s.
The port is single-controller, as the reference is: one host loop drives
every shard, and a sharded step runs shard by shard, each on its own
device.  Every reduction goes through ``Mesh.all_reduce``, which sums the
partial results in a fixed shard order on the first shard's device and
copies the sum back to each shard; no collective library is involved.
A mesh may list one device more than once (``["cpu"] * 4`` in the tests,
``[cuda:0] * 4`` on one card): the shards then share that device, and
the reduction's copies are no-ops.  A mesh built without devices names
shapes only (the rules and the dry run): its devices are ``meta``.

Production meshes (the repository's edge server of 4 GPUs):
  one server  : (1, 4)     -> ("data", "model")
  two servers : (2, 1, 4)  -> ("pod", "data", "model")
The ``pod`` axis carries only batch and replica parallelism: EPARA's rule
keeps a multi-GPU service inside one server, so model parallelism stays
inside a pod (``batch_axes`` applies unchanged).

The rules (``param_specs``, ``batch_specs``, ``cache_specs``,
``opt_state_specs``) are pure functions of shapes and key paths, and give
the reference's spec for the same shapes.  Every spec passes through
``_pick``, which shards only a dimension the axis divides.

The reference installs an activation constraint
(``models.sharding.set_activation_fn``) so that its scan carries stay
sharded under pjit.  The port's models do not call that hook: on a
head-sharded step every activation is whole on each shard after each
reduction, so there is nothing to constrain.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

SINGLE_SERVER_SHAPE = (1, 4)
MULTI_SERVER_SHAPE = (2, 1, 4)


class P(tuple):
    """A partition spec: one mesh axis name (or a tuple of names, or None)
    per dimension.  It compares like the tuple of its entries, as the
    reference's ``PartitionSpec`` does when taken as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Named axes over a row-major list of devices (see the module
    docstring).  ``shape`` maps each axis name to its size, as the
    reference's ``Mesh.shape`` does."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not name its axes "
                             f"{axis_names}")
        size = math.prod(shape)
        if devices is None:
            # a mesh of shapes only (the rules, the dry run): nothing runs
            # on the meta device
            devices = [torch.device("meta")] * size
        devices = [torch.device(d) for d in devices]
        if len(devices) != size:
            raise ValueError(f"a {shape} mesh needs {size} devices, got "
                             f"{len(devices)}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.devices: List[torch.device] = devices
        self.size = size
        self.reduce_calls = 0        # all_reduce and gather calls
        self.reduce_bytes = 0        # bytes their copies moved

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        stride = math.prod(list(self.shape.values())[k + 1:])
        return [self.devices[i * stride] for i in range(self.shape[axis])]

    def all_reduce(self, partials: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """The sum of one partial result a shard, on every shard.  The
        partials are summed in shard order on the first shard's device, in
        float32, and rounded to their dtype once; the sum is copied back to
        each shard's device.  One partial is returned as it is."""
        if len(partials) == 1:
            return [partials[0]]
        dev = partials[0].device
        acc = partials[0].float()
        for p in partials[1:]:
            acc = acc + p.to(dev).float()
        out = acc.to(partials[0].dtype)
        self.reduce_calls += 1
        self.reduce_bytes += 2 * (len(partials) - 1) * out.numel() \
            * out.element_size()
        return [out.to(p.device) for p in partials]

    def gather(self, parts: Sequence[torch.Tensor], dim: int = -1
               ) -> torch.Tensor:
        """The shards' parts concatenated along ``dim`` on the first
        shard's device (the vocabulary-sharded logits)."""
        if len(parts) == 1:
            return parts[0]
        dev = parts[0].device
        out = torch.cat([p.to(dev) for p in parts], dim=dim)
        self.reduce_calls += 1
        self.reduce_bytes += sum(p.numel() * p.element_size()
                                 for p in parts[1:])
        return out

    def __repr__(self) -> str:
        return (f"Mesh({tuple(self.shape.values())}, {self.axis_names}, "
                f"{[str(d) for d in self.devices]})")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    return Mesh(shape, axes, devices)


def make_production_mesh(*, multi_server: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """One edge server of 4 GPUs, or two (``multi_server``)."""
    if multi_server:
        return Mesh(MULTI_SERVER_SHAPE, ("pod", "data", "model"), devices)
    return Mesh(SINGLE_SERVER_SHAPE, ("data", "model"), devices)


def axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= axis_size(mesh, n)
        return out
    return mesh.shape[name] if name in mesh.shape else 1


def batch_axes(mesh):
    """The replica/batch mesh axes: ("pod","data") when a pod axis exists."""
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def _pick(mesh, shape: Tuple[int, ...], prefs: Dict[Any, List[int]]) -> P:
    """Build a spec: for each mesh axis (or axis tuple), assign the first
    preferred dim that is divisible by the axis size and not already
    taken.  Undividable/unclaimed dims stay replicated."""
    assignment: Dict[int, Any] = {}
    for axis, dims in prefs.items():
        size = axis_size(mesh, axis)
        if size <= 1:
            continue
        for d in dims:
            if d in assignment or d >= len(shape):
                continue
            if shape[d] % size == 0 and shape[d] > 0:
                assignment[d] = axis
                break
    spec = []
    for d in range(len(shape)):
        a = assignment.get(d)
        if isinstance(a, (tuple, list)):   # a singleton axis tuple is its
            a = a[0] if len(a) == 1 else tuple(a)   # one name
        spec.append(a)
    return P(*spec)


# ---------------------------------------------------------------------------
# trees: nested dicts, NamedTuples (optimizer states) and lists
# ---------------------------------------------------------------------------

def _key_str(kind: str, key) -> str:
    """One path entry as the reference's ``_path_str`` renders a JAX key:
    a dict key as itself, a NamedTuple field as ``.name``, a list index as
    its number."""
    return f".{key}" if kind == "attr" else str(key)


def tree_map_with_path(fn, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts (keys in sorted order, the
    reference's flatten order), NamedTuples and lists; ``path`` is a tuple
    of the entries' strings.  A spec ``P`` is a leaf."""
    if isinstance(tree, P):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(
            fn, getattr(tree, f), path + (_key_str("attr", f),))
            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_flatten_with_path(tree) -> List[Tuple[Tuple, Any]]:
    out: List[Tuple[Tuple, Any]] = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------

_PARAM_RULES: List[Tuple[str, Dict[str, List[int]]]] = [
    # pattern (on the /-joined tree path), prefs by logical axis name.
    # dims are counted FROM THE RIGHT (negative) to be stack-agnostic:
    # a rule for (d, f) applies equally to layer-stacked (L, d, f).
    (r"embed/embedding$", {"model": [-2], "fsdp": [-1]}),
    (r"embed/unembed$", {"model": [-1], "fsdp": [-2]}),
    (r"(attn|self_attn|cross_attn)/w[qkv]$", {"model": [-1], "fsdp": [-2]}),
    (r"(attn|self_attn|cross_attn)/wqkv$", {"model": [-1], "fsdp": [-2]}),
    (r"(attn|self_attn|cross_attn)/bqkv$", {"model": [-1]}),
    (r"mlp/w_gateup$", {"model": [-1], "fsdp": [-2]}),
    (r"moe/w_gateup$", {"model": [-1], "fsdp": [-2]}),
    (r"(attn|self_attn|cross_attn)/b[qkv]$", {"model": [-1]}),
    (r"(attn|self_attn|cross_attn)/wo$", {"model": [-2], "fsdp": [-1]}),
    (r"mlp/w_(gate|up)$", {"model": [-1], "fsdp": [-2]}),
    (r"mlp/w_down$", {"model": [-2], "fsdp": [-1]}),
    (r"moe/router$", {"fsdp": [-2]}),
    (r"moe/w_(gate|up)$", {"model": [-1], "fsdp": [-2]}),
    (r"moe/w_down$", {"model": [-2], "fsdp": [-1]}),
    (r"in_proj$", {"model": [-1], "fsdp": [-2]}),
    (r"out_proj$", {"model": [-2], "fsdp": [-1]}),
    (r"conv_w$", {"model": [-1]}),
    (r"conv_b$", {"model": [-1]}),
]


def param_specs(mesh, params_shape, *, fsdp: bool = True,
                expert_parallel: bool = False):
    """Spec tree for a parameter tree (of tensors, meta or fake ones
    included).  ``fsdp=False`` replicates the row dimension (pure tensor
    parallelism, the serving mode).  FSDP rows span ("pod","data")."""
    fsdp_axis = batch_axes(mesh) if fsdp else None
    rules = list(_PARAM_RULES)
    if expert_parallel:
        # expert weights (L, E, d, f): E on the model axis
        rules = [(r"moe/w_(gate|up|gateup)$", {"model": [-3], "fsdp": [-2]}),
                 (r"moe/w_down$", {"model": [-3], "fsdp": [-1]})] + rules

    def spec_for(path, leaf):
        pstr = _path_str(path)
        shape = tuple(leaf.shape)
        for pat, prefs in rules:
            if re.search(pat, pstr):
                axis_prefs: Dict[Any, List[int]] = {}
                for logical, dims in prefs.items():
                    axis = {"model": "model", "fsdp": fsdp_axis}[logical]
                    if axis is None:
                        continue
                    axis_prefs[axis] = [d % len(shape) for d in dims
                                        if -d <= len(shape)]
                return _pick(mesh, shape, axis_prefs)
        return P()  # norms, scalars, biases: replicate

    return tree_map_with_path(spec_for, params_shape)


# ---------------------------------------------------------------------------
# batch / cache sharding rules
# ---------------------------------------------------------------------------

def batch_specs(mesh, batch_shape, *, replicate_batch: bool = False) -> Any:
    """tokens/labels (B, L) and embeddings (B, T, d): batch on the replica
    axes (replicated when B is not divisible, e.g. B=1).
    ``replicate_batch`` replicates everything."""
    baxes = batch_axes(mesh)

    def spec_for(path, leaf):
        if replicate_batch:
            return P(*([None] * len(leaf.shape)))
        return _pick(mesh, tuple(leaf.shape), {baxes: [0]})

    return tree_map_with_path(spec_for, batch_shape)


def cache_specs(mesh, cache_shape, *, replicate_batch: bool = False) -> Any:
    """Caches are (layers, B, ...) trees:
       attention k/v  (L, B, S, Hkv, hd) : B->data, Hkv|hd|S->model
       ssm conv       (L, B, k-1, ch)    : B->data, ch->model
       ssm state      (L, B, H, P, N)    : B->data, H|P->model
       cross k/v      (L, B, T, Hkv, hd) : same as attention.
    ``replicate_batch`` moves the data axis from the batch dim to the
    SEQUENCE dim of attention caches and to state dims for SSM."""
    baxes = batch_axes(mesh)

    def spec_for(path, leaf):
        pstr = _path_str(path)
        shape = tuple(leaf.shape)
        if pstr.endswith("len"):
            return P()
        if "conv" in pstr:
            prefs = ({"model": [3]} if replicate_batch
                     else {baxes: [1], "model": [3]})
            return _pick(mesh, shape, prefs)
        if "ssd" in pstr:
            prefs = ({baxes: [2], "model": [3]} if replicate_batch
                     else {baxes: [1], "model": [2, 3]})
            return _pick(mesh, shape, prefs)
        if shape and len(shape) == 5:      # attention caches
            prefs = ({baxes: [2], "model": [3, 4]} if replicate_batch
                     else {baxes: [1, 2], "model": [3, 4, 2]})
            return _pick(mesh, shape, prefs)
        return _pick(mesh, shape, {} if replicate_batch else {baxes: [1]})

    return tree_map_with_path(spec_for, cache_shape)


def opt_state_specs(mesh, opt_shape, params_spec) -> Any:
    """Optimizer state: moments follow the param sharding; scalars
    replicate; Adafactor's factored moments inherit the surviving dims."""
    flat_params = tree_flatten_with_path(params_spec)

    def spec_for(path, leaf):
        pstr = _path_str(path)
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        # the param this moment mirrors, by suffix match
        for ppath, pspec in flat_params:
            ps = _path_str(ppath)
            if pstr.endswith(ps) or ps.endswith(pstr.split("/", 1)[-1]):
                if len(pspec) == len(shape):
                    ok = all(s % axis_size(mesh, a) == 0
                             for s, a in zip(shape, tuple(pspec)
                                             + (None,) * len(shape))
                             if a is not None)
                    if ok:
                        return pspec
                break
        # otherwise: the biggest divisible dims
        return _pick(mesh, shape, {"model": [len(shape) - 1],
                                   "data": [len(shape) - 2]})

    return tree_map_with_path(spec_for, opt_shape)


def shard_bytes(mesh, leaf, spec) -> int:
    """Bytes of one device's shard of ``leaf`` under ``spec``: each
    sharded dimension divided by its axes' size."""
    n = leaf.element_size() if hasattr(leaf, "element_size") \
        else leaf.dtype.itemsize
    for s, a in zip(tuple(leaf.shape), tuple(spec) + (None,) * leaf.ndim):
        n *= s // axis_size(mesh, a)
    return n
