"""Step builders (the port of the reference package's ``launch/steps.py``).

``build_step`` returns a ``StepBundle``: the step as a callable, its
argument tree as fake tensors (nothing allocated on a device) and the
spec trees, for one (arch x input shape x mesh).  ``dryrun.py`` traces
it under the bundle's ``FakeTensorMode``.

Shape -> step mapping:
  train_4k               -> train_step (loss + grads + optimizer update)
  prefill_32k            -> serve_prefill (logits of last position + cache)
  decode_32k / long_500k -> serve_decode (ONE token vs a seq_len cache)

The port trains and prefills nothing sharded: the bundle's step is the
whole step, and its spec trees say how the reference's pjit would place
its arguments.

``paged_decode_builder`` is the serving side: a service's paged decode
and chunk steps (any of the six families), and the dense and MoE
families' speculative verify, dense-view step and one-shot prefill,
split by heads over the ``model`` axis of a service mesh (EPARA's
model-parallel mode, ``--pjit-decode``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import config_for_shape, reduced
from repro_torch.kernels.quant import QuantPages
from repro_torch.models import encdec, hybrid, layers, moe, ssm, transformer
from repro_torch.models.config import ModelConfig, SHAPES_BY_NAME, ShapeSpec
from repro_torch.models.registry import model_api
from repro_torch.serving.arena import (Sections, pool_sections,
                                       sections_fit, take_shard)
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_step import make_train_step

from . import mesh as meshlib

ADAFACTOR_THRESHOLD = 50e9     # params above this train with adafactor

# what the head-sharded step does not cover, named by the ROADMAP.md
# Queue 1 item that would port it
TP_ITEM = ("ROADMAP.md Queue 1 item 15 (tensor parallelism, what stays "
           "refused: sync, the dense cache, FSDP serving, head_dim splits, "
           "more than one SSD group, and speculation, the dense-view step "
           "and one-shot prefill of the families other than dense and MoE)")


def choose_optimizer(cfg: ModelConfig) -> str:
    return "adafactor" if cfg.param_count() > ADAFACTOR_THRESHOLD \
        else "adamw"


def choose_microbatches(cfg: ModelConfig, shape: ShapeSpec,
                        batch_shards: int = 16) -> int:
    if shape.kind != "train":
        return 1
    if cfg.param_count() > ADAFACTOR_THRESHOLD:
        k = 16
    elif cfg.param_count() > 5e9:
        k = 4
    else:
        k = 2
    # each microbatch must still shard evenly over the batch axes
    while k > 1 and (shape.global_batch // k) % batch_shards != 0:
        k //= 2
    return k


# ---------------------------------------------------------------------------
# abstract trees: shapes and dtypes, nothing allocated
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig, mode: Optional[FakeTensorMode] = None):
    """``cfg``'s parameter tree as fake CPU tensors made under ``mode`` (a
    new ``FakeTensorMode`` unless given): the init runs, its draws and
    buffers are fake, so a full-width tree costs no memory."""
    mode = mode or FakeTensorMode()
    with mode:
        return model_api(cfg).init(0, cfg, "cpu")


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                mode: FakeTensorMode) -> Dict[str, Any]:
    """Fake tensors for every model input of (cfg, shape), as the
    reference's ``registry.input_specs`` gives them."""
    B, L = shape.global_batch, shape.seq_len
    tok = dict(dtype=torch.int32, device="cpu")
    with mode:
        specs: Dict[str, Any] = {}
        if shape.kind == "train":
            specs["tokens"] = torch.zeros((B, L), **tok)
            specs["labels"] = torch.zeros((B, L), **tok)
        elif shape.kind == "prefill":
            specs["tokens"] = torch.zeros((B, L), **tok)
        else:   # decode: one new token + a cache of length L (built apart)
            specs["token"] = torch.zeros((B,), **tok)
        emb = dict(dtype=cfg.compute_dtype, device="cpu")
        if cfg.family == "audio" and shape.kind != "decode":
            specs["embeddings"] = torch.zeros(
                (B, cfg.encoder_len, cfg.d_model), **emb)
        if cfg.family == "vlm" and shape.kind != "decode":
            specs["embeddings"] = torch.zeros(
                (B, cfg.prefix_len, cfg.d_model), **emb)
            # text tokens shrink so prefix + text == the assigned seq_len
            specs["tokens"] = torch.zeros((B, L - cfg.prefix_len), **tok)
            if shape.kind == "train":
                specs["labels"] = torch.zeros((B, L - cfg.prefix_len),
                                              **tok)
    return specs


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable                     # the whole step, run eagerly
    args: Tuple[Any, ...]            # fake tensor trees
    in_specs: Tuple[Any, ...]        # spec trees of ``args``
    out_specs: Any
    cfg: ModelConfig
    shape: ShapeSpec
    mesh: Any
    mode: FakeTensorMode             # the mode ``args`` were made under
    microbatches: int = 1
    optimizer: str = "none"


def build_step(arch: str, shape_name: str, mesh, *,
               fsdp_params: bool = True,
               microbatches: Optional[int] = None,
               optimizer_name: Optional[str] = None,
               pad_vocab_multiple: Optional[int] = None,
               serve_2d_tp: bool = False,
               expert_parallel: bool = False,
               reduce: bool = False) -> StepBundle:
    """The step of (arch, shape) with its fake argument trees and spec
    trees over ``mesh``.  The reference also lowers the step
    (``lower_step``); the port compiles nothing, so there is no
    ``lower_step``: ``dryrun.py`` traces ``fn(*args)`` under ``mode``.
    ``reduce`` takes the arch's reduced config (at the same shape)."""
    cfg = config_for_shape(arch, shape_name)
    if reduce:
        cfg = reduced(cfg)
    if pad_vocab_multiple:
        v = -(-cfg.vocab_size // pad_vocab_multiple) * pad_vocab_multiple
        cfg = dataclasses.replace(cfg, vocab_size=v)
    shape = SHAPES_BY_NAME[shape_name]
    api = model_api(cfg)
    mode = FakeTensorMode()
    params = abstract_params(cfg, mode)
    pspecs = meshlib.param_specs(mesh, params, fsdp=fsdp_params,
                                 expert_parallel=expert_parallel)
    batch = input_specs(cfg, shape, mode)

    if shape.kind == "train":
        opt_name = optimizer_name or choose_optimizer(cfg)
        opt = get_optimizer(opt_name)
        batch_shards = 1
        for ax in ("pod", "data"):
            batch_shards *= mesh.shape.get(ax, 1)
        nmb = microbatches or choose_microbatches(cfg, shape, batch_shards)
        with mode:
            opt_state = opt.init(params)
        ospecs = meshlib.opt_state_specs(mesh, opt_state, pspecs)
        bspecs = meshlib.batch_specs(mesh, batch)
        # bf16 grad accumulation for 100B+ configs, as the reference's
        accum = (torch.bfloat16 if cfg.param_count() > ADAFACTOR_THRESHOLD
                 else torch.float32)
        fn = make_train_step(cfg, opt, num_microbatches=nmb,
                             accum_dtype=accum)
        args, in_specs = (params, opt_state, batch), (pspecs, ospecs, bspecs)
        out_specs = (pspecs, ospecs, None)
        name = f"{arch}:{shape_name}:train[{opt_name},mb={nmb}]"
    elif shape.kind == "prefill":
        bspecs = meshlib.batch_specs(mesh, batch)
        cache_size = shape.seq_len

        def fn(p, b):
            with torch.no_grad():
                return api.prefill(p, cfg, b, cache_size=cache_size)

        with mode:
            cache = api.init_cache(cfg, shape.global_batch, cache_size,
                                   device="cpu")
        cspecs = meshlib.cache_specs(mesh, cache)
        args, in_specs = (params, batch), (pspecs, bspecs)
        out_specs = (None, cspecs)
        name = f"{arch}:{shape_name}:prefill"
    else:  # decode
        with mode:
            cache = api.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   device="cpu")
            # the cache arrives full: len = seq_len
            cache["len"] = torch.full((), shape.seq_len, dtype=torch.int32)
        cspecs = meshlib.cache_specs(mesh, cache,
                                     replicate_batch=serve_2d_tp)
        token = batch["token"]
        tspec = meshlib.batch_specs(mesh, {"token": token},
                                    replicate_batch=serve_2d_tp)["token"]

        def fn(p, tok, c):
            with torch.no_grad():
                return api.decode_step(p, cfg, tok, c)

        args, in_specs = (params, token, cache), (pspecs, tspec, cspecs)
        out_specs = (None, cspecs)
        name = f"{arch}:{shape_name}:decode" + \
            ("[2dtp]" if serve_2d_tp else "")
    return StepBundle(name=name, fn=fn, args=args, in_specs=in_specs,
                      out_specs=out_specs, cfg=cfg, shape=shape, mesh=mesh,
                      mode=mode,
                      microbatches=nmb if shape.kind == "train" else 1,
                      optimizer=(opt_name if shape.kind == "train"
                                 else "none"))


# ---------------------------------------------------------------------------
# serving: head-sharded paged decode and chunk steps (EPARA's MP mode)
# ---------------------------------------------------------------------------

def _paged_leaf_spec(mesh, leaf):
    """Spec for one arena device buffer.  Page pools
    ``(layers, pages, block_size, Hkv, D)`` shard their head/head_dim axes
    over the model axis, while the PAGE axis stays replicated (the block
    table's page indirection must resolve locally).  Smaller state leaves
    shard their channel axis when divisible."""
    nd = leaf.ndim
    if nd >= 4:
        prefs: Dict[Any, list] = {"model": [nd - 2, nd - 1]}
    elif nd >= 3:
        prefs = {"model": [nd - 1]}
    else:
        prefs = {}
    return meshlib._pick(mesh, tuple(leaf.shape), prefs)


def _pool_sharding(mesh, pool):
    """Spec(s) for one page pool.  An int8 pool is two leaves: the values
    shard like a dense pool, the per-row scale pool ``(layers, pages,
    block_size, Hkv)`` only its trailing Hkv axis, never the token
    axis."""
    if isinstance(pool, QuantPages):
        return QuantPages(
            _paged_leaf_spec(mesh, pool.values),
            meshlib._pick(mesh, tuple(pool.scales.shape),
                          {"model": [pool.scales.ndim - 1]}))
    return _paged_leaf_spec(mesh, pool)


def _model_dim(spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def _head_sharded(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s family registers head-sharded paged steps."""
    return model_api(cfg).decode_step_paged_tp is not None


def _mamba_leaf(cfg: ModelConfig, path) -> bool:
    """Whether ``path`` is a Mamba-2 layer's leaf: an SSM's ``blocks`` or
    the hybrid's ``mamba`` stack."""
    return (cfg.family, path[0]) in (("ssm", "blocks"), ("hybrid", "mamba"))


def _kv_replicated(cfg: ModelConfig, tp: int) -> bool:
    """Whether ``tp`` shards hold fewer kv heads than there are shards,
    each kv head then whole on ``tp / num_kv_heads`` of them."""
    return tp > 1 and cfg.num_kv_heads % tp != 0


def _ssm_sections(cfg: ModelConfig) -> Dict[str, Sections]:
    """Mamba-2's fused leaves by section: in_proj's columns ``z | x | B |
    C | dt`` and the conv's channels ``x | B | C``; z, x and dt split by
    heads, B and C (``ssm_ngroups = 1``) whole on every shard.  (The
    reference's rule cuts contiguous columns; splitting by section keeps
    each shard's heads together, a deviation kept on purpose.)"""
    H, di = cfg.ssm_nheads, cfg.d_inner
    bc = ((cfg.ssm_ngroups * cfg.ssm_state, False),) * 2
    return {"in_proj": ((di, True), (di, True), *bc, (H, True)),
            "conv_w": ((di, True), *bc), "conv_b": ((di, True), *bc)}


def leaf_split(cfg: ModelConfig, path, spec
               ) -> Optional[Tuple[int, Optional[Sections]]]:
    """How the head-sharded step splits one parameter leaf: (its dimension
    counted from the right, its sections or None) or None (whole on every
    shard).  The spec's model dimension, with a fused leaf split by
    section: ``wqkv``/``bqkv`` by q, k and v heads, ``w_gateup`` by its
    gate and up halves, Mamba-2's ``in_proj`` and conv as
    ``_ssm_sections`` says; and Mamba-2's per-head leaves (``A_log``,
    ``dt_bias``, ``D``, ``gate_ln``), which the reference's rules
    replicate, by head.  The k and v columns split by kv head, and where
    there are fewer kv heads than shards each shard takes its kv head's
    whole (``pool_sections``: the Megatron rule, where the reference's
    would cut head_dim)."""
    name = path[-1]
    if _mamba_leaf(cfg, path):
        fused = _ssm_sections(cfg)
        if name in fused:
            return -1, fused[name]
        if name in ("A_log", "dt_bias", "D") or tuple(path[-2:]) == (
                "gate_ln", "w"):
            return -1, None
    dim = _model_dim(spec)
    if dim is None:
        return None
    hd, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    kv = ((nkv * hd, nkv),)
    qkv = ((nq * hd, True), *kv, *kv)
    fused = {"wqkv": qkv, "bqkv": qkv, "wk": kv, "wv": kv, "bk": kv,
             "bv": kv, "w_gateup": ((cfg.d_ff, True), (cfg.d_ff, True))}
    return dim - len(spec), fused.get(name)


def state_split(cfg: ModelConfig, key: str) -> Tuple[int, Sections]:
    """How the head-sharded step splits one per-slot state leaf of the
    arena (``KVArena(state_split=...)``): (its dimension, its sections).
    The SSD state ``(L, B, H, P, N)`` on H (the reference's
    ``_paged_leaf_spec`` puts ``model`` on P: a deviation kept on purpose,
    each shard scans its own heads); the conv tail ``(L, B, k-1, ch)`` by
    ``_ssm_sections``' channels (an SSM's or the hybrid's); the cross K/V
    and a window ring's K/V ``(L, B, T, Hkv, D)`` on Hkv, as the pools
    split."""
    mamba = cfg.family in ("ssm", "hybrid")
    if mamba and key == "ssd":
        return 2, ((cfg.ssm_nheads, True),)
    if mamba and key == "conv":
        return 3, _ssm_sections(cfg)["conv_w"]
    if key in ("cross_k", "cross_v", "k", "v"):
        return 3, pool_sections(cfg.num_kv_heads)
    raise ValueError(f"{cfg.name}: no head split for the state leaf "
                     f"{key!r} ({TP_ITEM})")


@dataclasses.dataclass
class _Plan:
    """How a config splits over ``tp`` shards."""
    tp: int
    cfg_shard: ModelConfig
    vocab_split: bool
    mlp_split: bool


# each family's attention and FFN subtrees, by their paths' prefixes
_ATTENTION = {"dense": (("blocks", "attn"),), "moe": (("blocks", "attn"),),
              "audio": (("enc_blocks", "attn"), ("dec_blocks", "self_attn"),
                        ("dec_blocks", "cross_attn")), "ssm": (),
              "hybrid": (("shared", "attn"),), "vlm": (("blocks", "attn"),)}
_FFN = {"dense": (("blocks", "mlp"),), "moe": (("blocks", "moe"),),
        "audio": (("enc_blocks", "mlp"), ("dec_blocks", "mlp")),
        "ssm": (("blocks", "out_proj"),),
        "hybrid": (("shared", "mlp"), ("mamba", "out_proj")),
        "vlm": (("blocks", "mlp"),)}


def _split_plan(cfg: ModelConfig, pspecs, tp: int) -> _Plan:
    """Check the specs against what the head-sharded step can run and
    return the plan: attention split by whole kv heads (the GQA group of
    kv head j, query heads [j*G, (j+1)*G), on j's shard; with fewer kv
    heads than shards, the query heads split evenly and each shard holds
    its kv head whole), the FFN (the MLP, each expert, Mamba-2's
    ``out_proj``) by its hidden columns and rows where the rule divides
    them, the vocabulary where it divides it.  The MoE router stays
    whole.  A Mamba-2 layer's config is the whole model's (its steps read
    a shard's SSD heads from its parameters); the hybrid's shard config
    counts its attention heads."""
    specs = meshlib.tree_flatten_with_path(pspecs)
    for path, spec in specs:
        if tp > 1 and tuple(path[:2]) in _ATTENTION[cfg.family]:
            want = len(spec) - (2 if path[-1] == "wo" else 1)
            if _model_dim(spec) != want:
                raise ValueError(f"{cfg.name}: {'/'.join(path)} spec {spec} "
                                 f"does not split heads ({TP_ITEM})")
    ffn = {path: _model_dim(spec) is not None for path, spec in specs
           if tuple(path[:2]) in _FFN[cfg.family] and path[-1] != "router"}
    if len(set(ffn.values())) > 1:
        raise ValueError(f"{cfg.name}: the FFN's specs split some of its "
                         f"leaves and not others: {ffn} ({TP_ITEM})")
    if cfg.family in ("ssm", "hybrid") and tp > 1 and not all(
            ffn[p] for p in ffn if _mamba_leaf(cfg, p)):
        raise ValueError(f"{cfg.name}: out_proj's rows do not split over "
                         f"{tp} shards ({TP_ITEM})")
    embed = pspecs["embed"]
    vsplit = _model_dim(embed["embedding"]) is not None
    if "unembed" in embed and (_model_dim(embed["unembed"]) is not None) \
            != vsplit:
        raise ValueError(f"{cfg.name}: embedding and unembed split "
                         f"differently ({TP_ITEM})")
    kv_parts = min(cfg.num_kv_heads, tp)
    cfg_shard = cfg if cfg.family == "ssm" else dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // kv_parts)
    return _Plan(tp=tp, cfg_shard=cfg_shard, vocab_split=vsplit,
                 mlp_split=all(ffn.values()))


def shard_params(params, cfg: ModelConfig, pspecs, devices: List) -> List:
    """Split a parameter tree into one tree a shard, on the shard's
    device, as ``leaf_split`` says for each leaf: a leaf kept whole is the
    same tensor on every shard on its device (no copy), a split leaf's
    part is copied out.  The fused ``wqkv``/``bqkv`` split q, k and v by
    heads, ``w_gateup`` its gate and up halves and Mamba-2's ``in_proj``
    and conv their sections, never contiguous columns across sections."""
    tp = len(devices)
    specs = dict(meshlib.tree_flatten_with_path(pspecs))

    def build(s: int, dev):
        def leaf(path, t):
            split = leaf_split(cfg, path, specs[path]) if tp > 1 else None
            if split is not None:
                dim, sections = split
                t = take_shard(t, t.ndim + dim, s, tp, sections).contiguous()
            return t.to(dev)
        return meshlib.tree_map_with_path(leaf, params)

    return [build(s, dev) for s, dev in enumerate(devices)]


def tp_refusal(cfg: ModelConfig, tp: int, *, mode: str, kvcache_impl: str,
               paged_native: bool, draft: bool,
               chunked_prefill: bool = True) -> Optional[str]:
    """Why the head-sharded paged step cannot serve this service over
    ``tp`` model shards, or None: it serves every family on the
    paged-native continuous path with chunked prefill (an SSM's state
    step: it pages nothing), and the dense and MoE families also with a
    draft (speculation), on the dense-view step (a ring layout, the
    ``paged_native=False`` oracle) and with one-shot prefill, over a
    ``tp`` that divides the SSD heads and either divides the kv heads or
    is a multiple of them that divides the query heads (each kv head then
    replicated on ``tp / num_kv_heads`` shards, the Megatron rule)."""
    api = model_api(cfg)
    refuse = []
    if not _head_sharded(cfg):
        refuse.append(f"the {cfg.family!r} family")
    if mode != "continuous":
        refuse.append(f"mode={mode!r}")
    if kvcache_impl != "paged":
        refuse.append("the dense cache")
    elif not paged_native and cfg.family != "ssm" \
            and api.decode_step_tp is None:
        refuse.append(f"the dense-view step of the {cfg.family!r} family")
    if draft and api.verify_step_paged_tp is None:
        refuse.append(f"a draft model for the {cfg.family!r} family")
    if not chunked_prefill and api.prefill_tp is None:
        refuse.append(f"one-shot prefill of the {cfg.family!r} family")
    if cfg.family in ("ssm", "hybrid"):
        if cfg.ssm_nheads % tp:
            refuse.append(f"{cfg.ssm_nheads} SSD heads over tp={tp}")
        if tp > 1 and cfg.ssm_ngroups != 1:
            refuse.append(f"{cfg.ssm_ngroups} SSD groups (B and C stay "
                          f"whole on every shard at one group)")
    if cfg.family != "ssm" and (not sections_fit(
            pool_sections(cfg.num_kv_heads), tp) or cfg.num_heads % tp):
        # the reference's rules would shard head_dim here, attention with
        # partial scores reduced over the shards: a deviation kept on
        # purpose, the step splits whole kv heads only (or replicates
        # them, where tp is a multiple of them)
        refuse.append(f"{cfg.num_kv_heads} kv heads and {cfg.num_heads} "
                      f"query heads over tp={tp} (the step splits or "
                      f"replicates whole kv heads, not head_dim)")
    if not refuse:
        return None
    return (f"{cfg.name}: the head-sharded paged step serves every family "
            f"on the paged-native continuous path, and the dense and MoE "
            f"families with a draft, the dense-view step and one-shot "
            f"prefill; not {', '.join(refuse)} ({TP_ITEM})")


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one device when 0 is the current."""
    idx = lambda d: (torch.cuda.current_device()
                     if d.type == "cuda" and d.index is None else d.index)
    return a.type == b.type and idx(a) == idx(b)


class ShardedPagedStep:
    """A service's decode and chunk steps (paged-native, an SSM's state
    steps, or the dense-view step of a ring layout or the
    ``paged_native=False`` oracle), speculation's verify and one-shot
    prefill, split by heads over the model axis of ``mesh``: built by
    ``paged_decode_builder`` for ``ServiceRuntime(paged_step_builder=...)``.

    The host loop, scheduler and block tables stay single.  Each shard
    holds its heads' weights, its heads' page pools (the arena's
    ``shard_pages``) and its share of the per-slot state (``shard_state``)
    on its device; the family's ``*_tp`` steps run the shards one after
    another and reduce the partial outputs through the mesh.  The
    dense-view step gathers each shard's view of its pools
    (``arena.dense_view(..., shard=j)``), runs ``decode_step_tp`` or
    ``prefill_chunk_tp`` over them and writes the new rows back into each
    shard's pools; a ring's K/V is per-slot state, split and written in
    place.  A self-draft runs through the target's step (the same shard
    trees) over a draft arena split as the target's (``draft=True``:
    always paged-native).  The host-fed operands (tokens, lengths, the
    live mask, block tables, an audio request's frames, a VLM request's
    image rows) are copied to each distinct device.  Every kernel launch
    of the unsharded step becomes ``tp`` launches."""

    def __init__(self, runtime, mesh, *, shards: Optional[List] = None):
        cfg = runtime.cfg
        why = tp_refusal(cfg, mesh.shape.get("model", 1),
                         mode=runtime.mode,
                         kvcache_impl=runtime.kvcache_impl,
                         paged_native=runtime.paged_native,
                         draft=runtime.speculate_k > 0,
                         chunked_prefill=runtime.chunked_prefill)
        if why is not None:
            raise ValueError(why)
        for ax, n in mesh.shape.items():
            if ax != "model" and n != 1:
                raise ValueError(
                    f"a service mesh splits one replica over its model "
                    f"axis; its {ax!r} axis has {n} (replicas are the "
                    f"plan's DP groups)")
        self.mesh = mesh
        self.devices = mesh.axis_devices("model")
        if not _same_device(self.devices[0], runtime.device):
            raise ValueError(f"the mesh's first device {self.devices[0]} is "
                             f"not the runtime's {runtime.device}")
        self.cfg = cfg
        self.api = model_api(cfg)
        # the target's decode and chunk steps gather dense views: a ring
        # layout or the oracle (an SSM's state step pages nothing)
        self.dense = not runtime.paged_native and cfg.family != "ssm"
        if (shards is None) == (runtime.params is None):
            raise ValueError("a head-sharded runtime takes its whole "
                             "parameter tree or its shards (init_sharded), "
                             "one of the two")
        whole = runtime.params if shards is None else abstract_params(cfg)
        pspecs = meshlib.param_specs(mesh, whole, fsdp=False)
        self.plan = _split_plan(cfg, pspecs, len(self.devices))
        shard_trees = (shard_params(runtime.params, cfg, pspecs, self.devices)
                       if shards is None else shards)
        if len(shard_trees) != self.plan.tp:
            raise ValueError(f"{len(shard_trees)} shard trees for "
                             f"tp={self.plan.tp}")
        V = cfg.vocab_size
        tp = self.plan.tp
        self.shards = [transformer.Shard(
            params=p, cfg=self.plan.cfg_shard,
            vocab=((s * V // tp, (s + 1) * V // tp) if self.plan.vocab_split
                   else None), mlp_split=self.plan.mlp_split)
            for s, p in enumerate(shard_trees)]

    @property
    def tp(self) -> int:
        return self.plan.tp

    def state_split(self, key: str):
        """The arena's rule for a per-slot state leaf (``state_split``)."""
        return state_split(self.cfg, key)

    def check_arena(self, arena) -> None:
        """The arena's pools split by kv head as ``_pool_sharding`` places
        them over the mesh (with fewer kv heads than shards, where that
        rule would cut head_dim, each kv head's pool whole on its shards:
        ``pool_sections``), and its per-slot state by ``state_split``, each
        shard's part on the shard's device."""
        if arena.pages and not _kv_replicated(self.cfg, self.tp):
            spec = _pool_sharding(self.mesh, arena.full_pool_like())
            vals = spec.values if isinstance(spec, QuantPages) else spec
            if self.tp > 1 and _model_dim(vals) != len(vals) - 2:
                raise ValueError(f"pool spec {vals} does not split kv heads "
                                 f"({TP_ITEM})")
        want = [self.state_split(k) if self.tp > 1 else None
                for k in arena.state_keys]
        if arena._state_splits != want or len(arena.shard_state) != self.tp \
                or not all(_same_device(t.device, d)
                           for st, d in zip(arena.shard_state, self.devices)
                           for t in st):
            raise ValueError(f"the arena's per-slot state is not split by "
                             f"head over {self.devices} ({TP_ITEM})")

    def _each(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` on every shard's device (one copy a distinct device)."""
        copies: Dict[torch.device, torch.Tensor] = {}
        return [copies.setdefault(d, t.to(d)) for d in self.devices]

    def decode(self, arena, tokens, live, *, draft: bool = False):
        """One fused decode step over every slot; returns (logits
        (capacity, V) on the first device, the new lengths).  The
        dense-view step (not for a draft) gathers each shard's view, runs
        the dense step over it and writes each live slot's new row back
        into the shard's pools."""
        tables = [arena.device_block_tables(d) for d in self.devices]
        lens, live = self._each(arena.lens), self._each(live)
        tokens = self._each(tokens)
        if draft or not self.dense:
            caches = [arena.assemble(pages, state, n) for pages, state, n
                      in zip(arena.shard_pages, arena.shard_state, lens)]
            return self.api.decode_step_paged_tp(
                self.shards, self.cfg, tokens, caches, tables, live,
                block_size=arena.block_size, mesh=self.mesh)
        views = [arena.dense_view(pages, t, j) for j, (pages, t)
                 in enumerate(zip(arena.shard_pages, tables))]
        caches = [arena.assemble(v, state, n) for v, state, n
                  in zip(views, arena.shard_state, lens)]
        logits, new_len = self.api.decode_step_tp(
            self.shards, self.cfg, tokens, caches, live, mesh=self.mesh)
        for j, (pages, v, n, lv, t, c) in enumerate(zip(
                arena.shard_pages, views, lens, live, tables, caches)):
            arena.append_rows(pages, v, n, lv, t)
            arena.merge_state(arena.shard_state[j],
                              arena.disassemble(c)[1], lv)
        return logits, new_len

    def chunk(self, arena, sid: int, tokens, start, chunk_len,
              embeddings=None, *, draft: bool = False):
        """One chunk into slot ``sid`` (``tokens`` (1, T)) from ``start``;
        an audio request's first chunk carries its frame ``embeddings``
        (1, encoder_len, d), a VLM request's its image rows (1,
        prefix_len, d), to every shard.  The dense-view step (not for a
        draft) runs the dense chunk over each shard's view of the slot and
        appends the chunk's rows to the shard's pools.  Returns (logits
        (1, V) on the first device, the new length)."""
        row = torch.from_numpy(arena._block_tables[sid:sid + 1])
        starts, rows = self._each(start), self._each(row)
        tokens, chunk_len = self._each(tokens), self._each(chunk_len)
        if draft or not self.dense:
            caches = [arena.assemble(pages, arena.slot_state(sid, j), st)
                      for j, (pages, st) in enumerate(zip(arena.shard_pages,
                                                          starts))]
            kw = {} if embeddings is None else {
                "embeddings": self._each(embeddings)}
            return self.api.prefill_chunk_paged_tp(
                self.shards, self.cfg, tokens, caches, rows, chunk_len,
                block_size=arena.block_size, mesh=self.mesh, **kw)
        views = [arena.dense_view(pages, r, j) for j, (pages, r)
                 in enumerate(zip(arena.shard_pages, rows))]
        caches = [arena.assemble(v, arena.slot_state(sid, j), st)
                  for j, (v, st) in enumerate(zip(views, starts))]
        logits, new_len = self.api.prefill_chunk_tp(
            self.shards, self.cfg, tokens, caches, chunk_len, mesh=self.mesh)
        for pages, v, st, cl, r in zip(arena.shard_pages, views, starts,
                                       chunk_len, rows):
            arena.append_rows(pages, v, st, torch.ones(
                (1,), dtype=torch.bool, device=st.device), r,
                n_tokens=tokens[0].shape[1], valid_tokens=cl)
        return logits, new_len

    def verify(self, arena, tokens, chunk_len):
        """Speculative decoding's fused verify over every slot: ``tokens``
        (capacity, T) fed rows, ``chunk_len`` (capacity,) T or 0; every
        shard writes its heads' rows into its pools.  Returns (logits
        (capacity, T, V) on the first device, the lengths unchanged)."""
        tables = [arena.device_block_tables(d) for d in self.devices]
        caches = [arena.assemble(pages, state, n) for pages, state, n
                  in zip(arena.shard_pages, arena.shard_state,
                         self._each(arena.lens))]
        return self.api.verify_step_paged_tp(
            self.shards, self.cfg, self._each(tokens), caches, tables,
            self._each(chunk_len), block_size=arena.block_size,
            mesh=self.mesh)

    def prefill(self, batch, cache_size: int):
        """One-shot prefill of ``batch["tokens"]`` (1, L): returns (logits
        (1, V) on the first device, one cache a shard of its kv heads'
        rows, for ``arena.write_prefill``)."""
        return self.api.prefill_tp(self.shards, self.cfg,
                                   self._each(batch["tokens"]), cache_size,
                                   mesh=self.mesh)


def _stacks(cfg: ModelConfig):
    """A family's stacked layer subtrees, each (name, the family's
    ``init_block``, layers), in the order its ``init`` draws them, and its
    norms (no draws)."""
    if cfg.family == "audio":
        return ((("enc_blocks", encdec.init_encoder_block,
                  cfg.encoder_layers),
                 ("dec_blocks", encdec.init_decoder_block, cfg.num_layers)),
                ("ln_enc", "ln_f"))
    if cfg.family == "hybrid":
        return (("mamba", ssm.init_mamba_block, cfg.num_layers),), ("ln_f",)
    block = {"dense": transformer.init_block, "moe": moe.init_block,
             "ssm": ssm.init_mamba_block,
             "vlm": transformer.init_block}[cfg.family]
    return (("blocks", block, cfg.num_layers),), ("ln_f",)


def init_sharded(seed: int, cfg: ModelConfig, mesh) -> List:
    """A model's random weights from ``seed`` straight into one tree a
    model shard of ``mesh``, on the shard's device: the values of
    ``shard_params(<family>.init(seed, cfg, first device), ...)``, drawn a
    layer at a time on the first device through the family's
    ``init_block``, so that no device ever holds the whole tree
    (mistral-large-123b's 246 GB or mixtral-8x7b's 93.4 GB of bf16 weights
    split over 4 cards).  For ``ServiceRuntime(cfg, None, plan,
    paged_step_builder=paged_decode_builder(mesh, shards=...))``."""
    if not _head_sharded(cfg):
        raise ValueError(f"init_sharded draws the head-sharded families' "
                         f"weights, not {cfg.family!r} ({TP_ITEM})")
    devices = mesh.axis_devices("model")
    tp = len(devices)
    pspecs = meshlib.param_specs(mesh, abstract_params(cfg), fsdp=False)
    _split_plan(cfg, pspecs, tp)
    gen = torch.Generator(device=devices[0])
    gen.manual_seed(int(seed))
    embed = layers.init_embedding(gen, cfg)
    trees = [{"embed": t["embed"]} for t in shard_params(
        {"embed": embed}, cfg, {"embed": pspecs["embed"]}, devices)]
    del embed
    stacks, norms = _stacks(cfg)
    for name, init_block, n in stacks:
        blocks: List[Dict] = [{} for _ in devices]
        # a layer's spec is the stacked leaf's without the layer axis
        layer_specs = meshlib.tree_map_with_path(
            lambda _, p: meshlib.P(*p[1:]), pspecs[name])
        for i in range(n):
            # under the stack's name, so that the rules see its paths
            layer = [t[name] for t in shard_params(
                {name: init_block(gen, cfg)}, cfg, {name: layer_specs},
                devices)]
            for tree, part in zip(blocks, layer):
                def put(path, t, tree=tree):
                    node = tree
                    for k in path[:-1]:
                        node = node.setdefault(k, {})
                    if path[-1] not in node:
                        node[path[-1]] = torch.empty(
                            (n, *t.shape), dtype=t.dtype, device=t.device)
                    node[path[-1]][i].copy_(t)
                meshlib.tree_map_with_path(put, part)
        for tree, b in zip(trees, blocks):
            tree[name] = b
    if cfg.family == "hybrid":
        # the shared block, one weight set, drawn after the mamba stack
        for tree, part in zip(trees, shard_params(
                {"shared": hybrid.init_shared_block(gen, cfg)}, cfg,
                {"shared": pspecs["shared"]}, devices)):
            tree["shared"] = part["shared"]
    for norm in norms:
        w = layers.init_norm(cfg, devices[0])
        for tree, dev in zip(trees, devices):
            tree[norm] = {k: v.to(dev) for k, v in w.items()}
    return trees


def paged_decode_builder(mesh, *, fsdp_params: bool = False,
                         shards: Optional[List] = None) -> Callable:
    """Builder for ``ServiceRuntime(paged_step_builder=...)``: the
    runtime's parameters split by ``param_specs(fsdp=False)`` on head
    boundaries (``leaf_split``), the arena's pools by kv head and its
    per-slot state by ``state_split`` over ``mesh``'s model axis, and the
    paged decode and chunk steps run shard by shard.  The reference's
    builder jits only the decode step; here the chunk step runs sharded
    too, since it writes into the same per-shard pools and state.  Unlike
    the reference's ``builder(runtime, arena)``, the port's takes the
    runtime alone: the runtime builds its arena after it, split from the
    start, so no device ever holds the whole pool or state.  ``shards``
    (``init_sharded``'s trees) serve a runtime made without its whole
    tree (``params=None``).  ``fsdp_params`` keeps the reference's
    signature: the step splits whole heads over the model axis only, so
    ``True`` raises."""
    if fsdp_params:
        raise ValueError(f"the head-sharded step splits parameters over the "
                         f"model axis only; FSDP serving is not ported "
                         f"({TP_ITEM})")

    def builder(runtime):
        return ShardedPagedStep(runtime, mesh, shards=shards)

    return builder
