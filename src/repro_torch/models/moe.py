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
``prefill_chunk_paged``, ``decode_step_paged``, the one-shot ``prefill``
(the whole prompt one routing group, up to ``MAX_ROUTING_GROUP``) and the
dense-cache ``prefill_chunk``/``decode_step``.  ``forward_hidden``
(ROADMAP.md Queue 1 item 12) and ``verify_step_paged`` (item 4) raise,
naming their item.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

from . import layers, transformer
from .config import ModelConfig
from .transformer import layer_params


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


MAX_ROUTING_GROUP = 2048


def moe_mlp(p, cfg: ModelConfig, x):
    """x: (B, L, d) -> (B, L, d), plus the aux loss.

    Long sequences are split into routing groups of <= MAX_ROUTING_GROUP
    tokens (the last one zero-padded): expert capacity, and with it the
    (G, S, E, C) dispatch tensors, scales with the group, not the
    sequence."""
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
    if _DROP_COUNTER_ENABLED:
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
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], cfg, tokens).to(cfg.compute_dtype)
    start = torch.as_tensor(cache["len"], dtype=torch.int32,
                            device=x.device).reshape(-1)
    k_all, v_all = cache["k"], cache["v"]
    for i in range(cfg.num_layers):
        lp = layer_params(params["blocks"], i)
        xn = layers.apply_norm(lp["ln1"], cfg, x)
        h, _, _ = layers.attention_chunk_paged(
            lp["attn"], cfg, xn, k_all[i], v_all[i], block_tables, start,
            chunk_len, block_size=block_size, window=cfg.sliding_window)
        x = x + h
        m, _ = moe_mlp(lp["moe"], cfg, layers.apply_norm(lp["ln2"], cfg, x))
        x = x + m
    h = layers.take_chunk_last(x, chunk_len)
    h = layers.apply_norm(params["ln_f"], cfg, h[:, None])[:, 0]
    logits = logits_fn(params, cfg, h)
    return logits, {"k": k_all, "v": v_all, "len": start + chunk_len}


def decode_step_paged(params, cfg: ModelConfig, token, cache, block_tables,
                      live, *, block_size: int):
    """Paged-native fused decode (see ``transformer.decode_step_paged``):
    the per-slot routing groups keep every row independent of its batch
    neighbours, so dead slots' rows are harmless."""
    lens = cache["len"].to(torch.int32)
    live = live.bool()
    x = layers.embed(params["embed"], cfg, token).to(cfg.compute_dtype)
    k_all, v_all = cache["k"], cache["v"]
    for i in range(cfg.num_layers):
        lp = layer_params(params["blocks"], i)
        xn = layers.apply_norm(lp["ln1"], cfg, x)
        h, _, _ = layers.attention_decode_paged(
            lp["attn"], cfg, xn, k_all[i], v_all[i], block_tables, lens,
            live, block_size=block_size, window=cfg.sliding_window)
        x = x + h
        x = x + _moe_mlp_single(lp["moe"], cfg,
                                layers.apply_norm(lp["ln2"], cfg, x))
    h = layers.apply_norm(params["ln_f"], cfg, x)
    logits = logits_fn(params, cfg, h)
    return logits, {"k": k_all, "v": v_all,
                    "len": torch.where(live, lens + 1, lens)}


def moe_ffn(lp, cfg: ModelConfig, x):
    """The MoE block's FFN for ``transformer``'s dense steps: a decode batch
    (B, d) routes each slot's token alone, a prompt or chunk (B, L, d) is
    its own routing group."""
    if x.ndim == 2:
        return _moe_mlp_single(lp["moe"], cfg, x)
    return moe_mlp(lp["moe"], cfg, x)[0]


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


def _not_ported(name: str, item: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"moe.{name} is not ported to repro_torch yet: ROADMAP.md "
            f"Queue 1 {item}")
    fn.__name__ = name
    return fn


forward_hidden = _not_ported("forward_hidden", "item 12 (training)")
verify_step_paged = _not_ported("verify_step_paged",
                                "item 4 (speculation and forks)")
