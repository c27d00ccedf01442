"""Mixture-of-Experts decoder (mixtral-8x7b, grok-1-314b families): the
serving entry points.

GShard/Switch-style capacity-based top-k routing, as in the reference
package's ``models/moe.py``: tokens are grouped per sequence (at most
``MAX_ROUTING_GROUP`` a group), the dispatch and combine tensors are
(G, S, E, C) one-hots, and the expert FFN runs through
``ops.grouped_matmul``, the hand-written grouped-GEMM kernel on the card.
The attention backbone is the dense decoder's (``layers``); only the FFN
differs.

Parameters keep the reference's tree and stacked layer axis; the caches
are the arena's page pools or a dense cache, updated in place (see
``transformer``).

Ported: ``init``, ``logits_fn``, ``init_cache``, ``moe_mlp``,
``prefill_chunk_paged``, ``verify_step_paged``, ``decode_step_paged``, the
one-shot ``prefill`` (the whole prompt one routing group, up to
``MAX_ROUTING_GROUP``) and the dense-cache ``prefill_chunk``/
``decode_step``, and the training forward ``forward_hidden``, whose
expert GEMMs' gradients are grouped GEMMs again (``ops.grouped_matmul``).
"""
from __future__ import annotations

import contextlib
import itertools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

from . import layers, transformer
from .config import ModelConfig
from .transformer import unbind_layers


# ---------------------------------------------------------------------------
# router + dispatch
# ---------------------------------------------------------------------------

def init_moe_mlp(gen: torch.Generator, cfg: ModelConfig):
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    dt = cfg.weight_dtype
    return {"router": layers.dense_init(gen, (d, E), dt),
            "w_gate": layers.dense_init(gen, (E, d, f), dt),
            "w_up": layers.dense_init(gen, (E, d, f), dt),
            "w_down": layers.dense_init(gen, (E, f, d), dt)}


def _top_k_dispatch(router_probs, k: int, capacity: int):
    """router_probs: (G, S, E) f32.  Returns combine (G, S, E, C) f32, the
    aux load-balance loss and the number of token->expert assignments
    dropped by the capacity limit (a 0-d f32 tensor).  k rounds of argmax
    (lowest expert index on ties); a token's position in an expert is the
    count of earlier claims in its group, and past ``capacity`` it is
    dropped (zero combine weight: the residual passes it through).  The
    kept gates are renormalised to sum to 1 (mixtral semantics)."""
    G, S, E = router_probs.shape
    dev = router_probs.device
    combine = torch.zeros((G, S, E, capacity), dtype=torch.float32,
                          device=dev)
    probs = router_probs
    top1 = torch.argmax(probs, dim=-1)
    me = probs.mean(dim=1)                                 # (G, E)
    ce = F.one_hot(top1, E).float().mean(dim=1)            # (G, E)
    aux = (me * ce).sum(dim=-1).mean() * (E ** 2) / (E * 1.0)

    slots = torch.arange(capacity, device=dev)
    occupancy = torch.zeros((G, E), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(k):
        idx = torch.argmax(probs, dim=-1)                  # (G, S)
        gate = torch.gather(probs, -1, idx[..., None])[..., 0]
        mask = F.one_hot(idx, E)                           # (G, S, E)
        pos = torch.cumsum(mask, dim=1) - mask + occupancy[:, None]
        pos = (pos * mask).sum(dim=-1)                     # (G, S)
        keep = pos < capacity
        dropped = dropped + (~keep).sum().float()
        onehot_c = (pos[..., None] == slots).float()       # (G, S, C)
        combine = combine + (gate * keep)[..., None, None] \
            * mask[..., None].float() * onehot_c[..., None, :]
        occupancy = occupancy + mask.sum(dim=1)
        probs = probs * (1.0 - mask.to(probs.dtype))       # mask out chosen
    denom = combine.sum(dim=(-2, -1), keepdim=True)
    combine = combine / denom.clamp_min(1e-9)
    return combine, aux, dropped


# ---------------------------------------------------------------------------
# expert-capacity drop counter: chunked prefill changes the routing-group
# granularity, so outputs can diverge from one-shot prefill exactly when
# the capacity limit binds, i.e. when assignments are dropped.  The serving
# engine enables it for MoE services and reports per-step deltas in
# ``StepStats.moe_dropped_tokens``.  Each ``moe_mlp`` call adds its drops
# to a device tensor (no host sync per layer); ``flush()`` reads it into
# the host totals.  The engine flushes at the start of each step, so the
# step's delta holds no drops of calls made outside it, and at its end.
# Pending drops lie on one device: a caller that moves to another device
# outside a step flushes first, or turns the counter off.  The assignments
# are counted on the host: their number follows from the shapes.  Counts
# include the padding rows of chunks and the dead rows of a fixed-capacity
# decode batch, as in the reference: an observability signal, not a
# per-request audit.
# ---------------------------------------------------------------------------

class _MoeDropStats:
    __slots__ = ("dropped", "assigned", "_pending")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.dropped = 0.0
        self.assigned = 0.0
        self._pending = None

    def note(self, dropped, assigned: float) -> None:
        """Add one call's drops (a 0-d device tensor) without reading it."""
        if self._pending is None:
            self._pending = dropped.detach().clone()
        else:
            self._pending += dropped.detach()
        self.assigned += float(assigned)

    def flush(self) -> None:
        """Read the drops accumulated on the device into ``dropped``."""
        if self._pending is not None:
            self.dropped += float(self._pending.item())
            self._pending = None

    @property
    def drop_rate(self) -> float:
        return self.dropped / self.assigned if self.assigned else 0.0


MOE_DROP_STATS = _MoeDropStats()
_DROP_COUNTER_ENABLED = False


def enable_drop_counter(on: bool = True) -> None:
    """Toggle drop accounting for every ``moe_mlp`` call after this one."""
    global _DROP_COUNTER_ENABLED
    _DROP_COUNTER_ENABLED = bool(on)


@contextlib.contextmanager
def drops_uncounted():
    """``moe_mlp`` calls inside count no drops: a step traced on fake
    tensors (a cost analysis), or a head-sharded step's shards after the
    first, leave the counter as it was."""
    global _DROP_COUNTER_ENABLED
    was, _DROP_COUNTER_ENABLED = _DROP_COUNTER_ENABLED, False
    try:
        yield
    finally:
        _DROP_COUNTER_ENABLED = was


MAX_ROUTING_GROUP = 2048


def moe_mlp(p, cfg: ModelConfig, x, *, count_drops: bool = True):
    """x: (B, L, d) -> (B, L, d), plus the aux loss.

    Long sequences are split into routing groups of <= MAX_ROUTING_GROUP
    tokens (the last one zero-padded): expert capacity, and with it the
    (G, S, E, C) dispatch tensors, scales with the group, not the
    sequence.  ``count_drops=False`` keeps the call out of the drop
    counter (training, whose checkpoint recompute would count twice)."""
    B, L, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    seg = min(L, MAX_ROUTING_GROUP)
    pad = (-L) % seg
    xg = F.pad(x, (0, 0, 0, pad)) if pad else x
    G = xg.shape[1] // seg
    xg = xg.reshape(B * G, seg, d)
    capacity = max(1, int(cfg.moe_capacity_factor * k * seg / E))
    logits = layers.linear(xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)                  # (BG, seg, E)
    combine, aux, dropped = _top_k_dispatch(probs, k, capacity)
    if _DROP_COUNTER_ENABLED and count_drops:
        MOE_DROP_STATS.note(dropped, k * B * G * seg)
    dispatch = (combine > 0).to(x.dtype)                   # (BG, seg, E, C)
    # (BG, S, E, C) x (BG, S, d) -> (E, BG*C, d)
    expert_in = torch.einsum("blec,bld->ebcd", dispatch, xg)
    expert_in = expert_in.reshape(E, B * G * capacity, d)
    gate = ops.grouped_matmul(expert_in, p["w_gate"])
    up = ops.grouped_matmul(expert_in, p["w_up"])
    h = F.silu(gate.float()).to(x.dtype) * up
    out = ops.grouped_matmul(h, p["w_down"])
    out = out.reshape(E, B * G, capacity, d)
    y = torch.einsum("blec,ebcd->bld", combine.to(x.dtype), out)
    y = y.reshape(B, G * seg, d)
    return y[:, :L], aux


def _moe_mlp_single(p, cfg: ModelConfig, x_t):
    """Decode-time MoE for a (B, d) token batch: each slot's token is its
    own routing group (B groups of one token), so no token competes with
    its batch neighbours (or a fixed-capacity batch's dead rows) for
    expert capacity, and the grouped GEMMs still see one (E, B*C, d)
    stack."""
    y, _ = moe_mlp(p, cfg, x_t[:, None])
    return y[:, 0]


# ---------------------------------------------------------------------------
# blocks / model API (attention backbone shared with transformer)
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig):
    dev = gen.device
    return {"ln1": layers.init_norm(cfg, dev),
            "attn": layers.init_attention(gen, cfg),
            "ln2": layers.init_norm(cfg, dev),
            "moe": init_moe_mlp(gen, cfg)}


def _fill_layer(stack, tree, i: int) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _fill_layer(stack[k], v, i)
    else:
        stack[i].copy_(tree)


def _empty_stack(tree, n: int):
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n) for k, v in tree.items()}
    return torch.empty((n, *tree.shape), dtype=tree.dtype,
                       device=tree.device)


def init(seed: int, cfg: ModelConfig, device=None):
    """Random weights from ``seed`` on ``device`` (the card unless
    ``"cpu"``), in the reference's tree layout.  Each stacked leaf
    ``(layers, ...)`` is allocated once and filled layer by layer, so the
    expert weights are never held twice (stacking a list of layers would
    need twice their 47 GB at mixtral's 16 layers).  The draws differ from
    the reference's ``jax.random`` ones; tests carry reference weights over
    with ``repro_torch.bridge.params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    embed = layers.init_embedding(gen, cfg)
    blocks = None
    for i in range(cfg.num_layers):
        block = init_block(gen, cfg)
        if blocks is None:
            blocks = _empty_stack(block, cfg.num_layers)
        _fill_layer(blocks, block, i)
        del block
    return {"embed": embed, "blocks": blocks,
            "ln_f": layers.init_norm(cfg, dev)}


logits_fn = transformer.logits_fn
init_cache = transformer.init_cache


def prefill_chunk_paged(params, cfg: ModelConfig, batch, cache,
                        block_tables, *, chunk_len, block_size: int):
    """Paged-native chunked prefill (see ``transformer.prefill_chunk_paged``).
    The chunk is its own routing group: expert capacity scales with the
    bucket, not the prompt, and the padding rows past ``chunk_len`` compete
    for it as in the reference."""
    return transformer.prefill_chunk_paged_ffn(
        params, cfg, batch, cache, block_tables, chunk_len, block_size,
        moe_ffn)


def verify_step_paged(params, cfg: ModelConfig, batch, cache, block_tables,
                      *, chunk_len, block_size: int):
    """Speculative decoding's verify (see ``transformer.verify_step_paged``):
    logits (B, T, V) over all T positions, ``cache["len"]`` unchanged.
    Each slot's T rows are one routing group, as a chunk's are, so the
    drafts are scored at chunked prefill's routing granularity."""
    return transformer.verify_step_paged_ffn(
        params, cfg, batch, cache, block_tables, chunk_len, block_size,
        moe_ffn)


def decode_step_paged(params, cfg: ModelConfig, token, cache, block_tables,
                      live, *, block_size: int):
    """Paged-native fused decode (see ``transformer.decode_step_paged``):
    the per-slot routing groups keep every row independent of its batch
    neighbours, so dead slots' rows are harmless."""
    return transformer.decode_step_paged_ffn(
        params, cfg, token, cache, block_tables, live, block_size, moe_ffn)


def moe_ffn(lp, cfg: ModelConfig, x):
    """The MoE block's FFN for ``transformer``'s dense steps: a decode batch
    (B, d) routes each slot's token alone, a prompt or chunk (B, L, d) is
    its own routing group."""
    if x.ndim == 2:
        return _moe_mlp_single(lp["moe"], cfg, x)
    return moe_mlp(lp["moe"], cfg, x)[0]


def _ffn_counted_once(tp: int):
    """``moe_ffn`` for a head-sharded step over ``tp`` shards, which runs
    it on each shard in turn, layer by layer: every shard routes the same
    reduced rows alike and runs its experts' columns, and the calls of
    the shards after the first count no drops, so a step counts them
    once."""
    calls = itertools.count()

    def ffn(lp, cfg: ModelConfig, x):
        if next(calls) % tp == 0:
            return moe_ffn(lp, cfg, x)
        with drops_uncounted():
            return moe_ffn(lp, cfg, x)
    return ffn


def decode_step_paged_tp(shards, cfg: ModelConfig, token, caches,
                         block_tables, live, *, block_size: int, mesh=None):
    """``decode_step_paged`` over head shards (see
    ``transformer.decode_step_paged_tp``): each shard's expert FFN gives a
    partial ``w_down`` product of its columns, which the mesh reduces
    once a layer."""
    return transformer.decode_step_paged_tp(
        shards, cfg, token, caches, block_tables, live,
        block_size=block_size, mesh=mesh, ffn=_ffn_counted_once(len(shards)))


def prefill_chunk_paged_tp(shards, cfg: ModelConfig, tokens, caches,
                           block_tables, chunk_len, *, block_size: int,
                           mesh=None):
    """``prefill_chunk_paged`` over head shards (see
    ``decode_step_paged_tp``)."""
    return transformer.prefill_chunk_paged_tp(
        shards, cfg, tokens, caches, block_tables, chunk_len,
        block_size=block_size, mesh=mesh, ffn=_ffn_counted_once(len(shards)))


def prefill(params, cfg: ModelConfig, batch, *, cache_size=None):
    """One-shot prefill (see ``transformer.prefill``): each prompt is one
    routing group, so expert capacity scales with the prompt."""
    return transformer.prefill_ffn(params, cfg, batch, cache_size, moe_ffn)


def prefill_chunk(params, cfg: ModelConfig, batch, cache, *, chunk_len):
    """Chunked prefill against a dense cache (see
    ``transformer.prefill_chunk`` and ``prefill_chunk_paged``'s routing
    note)."""
    return transformer.prefill_chunk_ffn(params, cfg, batch, cache,
                                         chunk_len, moe_ffn)


def decode_step(params, cfg: ModelConfig, token, cache, *, live=None):
    """Fused decode against a dense cache (see ``transformer.decode_step``);
    per-slot routing groups keep every row independent."""
    return transformer.decode_step_ffn(params, cfg, token, cache, live,
                                       moe_ffn)


def _train_block(lp, cfg: ModelConfig, x, positions):
    """One layer of the training forward: (x out, the layer's aux loss)."""
    a, _ = layers.attention_with_kv(lp["attn"], cfg,
                                    layers.apply_norm(lp["ln1"], cfg, x),
                                    positions=positions, causal=True,
                                    window=cfg.sliding_window)
    x = x + a
    m, aux = moe_mlp(lp["moe"], cfg, layers.apply_norm(lp["ln2"], cfg, x),
                     count_drops=False)
    return x + m, aux


def forward_hidden(params, cfg: ModelConfig, batch, *, train: bool = False):
    """The final-norm hidden states (B, L, d) of ``batch["tokens"]``
    (B, L), and the aux load-balance loss summed over the layers and
    divided by their number.  With ``train`` each whole layer runs under a
    non-reentrant checkpoint (the reference's ``jax.checkpoint`` of the
    scan body), so its attention and expert GEMMs run again in the
    backward.  The drop counter never counts these calls."""
    tokens = batch["tokens"]
    h = layers.embed(params["embed"], cfg, tokens).to(cfg.compute_dtype)
    positions = torch.arange(tokens.shape[1], device=h.device)[None]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in unbind_layers(params["blocks"], cfg.num_layers):
        if train:
            h, a = checkpoint(_train_block, lp, cfg, h, positions,
                              use_reentrant=False)
        else:
            h, a = _train_block(lp, cfg, h, positions)
        aux = aux + a
    h = layers.apply_norm(params["ln_f"], cfg, h)
    return h, aux / cfg.num_layers
