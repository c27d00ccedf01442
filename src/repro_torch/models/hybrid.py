"""Zamba2-style hybrid (zamba2-7b): a Mamba-2 backbone with one SHARED
attention+MLP block applied after every ``attn_every`` mamba layers: the
serving entry points.

The shared block reads concat(h, h0) (h0 the token embeddings, the Zamba
trick) through one weight set at every application, and each application
keeps its own K/V.  The reference's ``lax.scan`` over ``n_apps`` groups
(``attn_every`` mamba layers, then the shared block) and over the tail of
leftover mamba layers becomes a loop over the flat layer index
``g * attn_every + j`` and the application index ``g``, then the tail
(``_split_groups``).

Parameters keep the reference's tree: ``embed``, ``mamba`` (every leaf
with a leading ``num_layers`` axis), ``shared``, ``ln_f``.  The cache is
``{"conv": (layers, B, k-1, ch), "ssd": (layers, B, H, P, N) f32,
"attn_k"/"attn_v": (n_apps, B, S, Hkv, D), "len"}``: per-slot recurrent
state beside sequence leaves, which the serving arena pages (``attn_k``,
``attn_v``) and keeps per slot (``conv``, ``ssd``) by probing
``init_cache``.  As in ``ssm.py``, every step but the one-shot
``prefill`` updates ``conv`` and ``ssd`` IN PLACE, layer by layer (the
reference's functional carry would hold a second copy of the state: 39 GB
at zamba2-7b's 256 slots), and the K/V it is given, dense or paged, in
place too.  The paged decode step writes only live slots' state and
rows.  ``forward_hidden`` is the training forward: the mamba layers
checkpointed, the shared block's applications not, as in the reference.

Every serving step runs over a list of ``transformer.Shard``s (its
``*_tp`` function: the one-shot ``prefill_tp``, the dense
``prefill_chunk_tp`` and ``decode_step_tp``, the paged
``prefill_chunk_paged_tp`` and ``decode_step_paged_tp``): one shard, the
whole tree, unsharded; ``tp`` head shards for the head-sharded step
(``launch/steps.py`` ``paged_decode_builder``).  A shard holds its SSD
heads of every mamba layer (split as ``ssm.py``'s, the gated norm's sum
of squares reduced over the shards), its attention heads and MLP columns
of the shared block, and each application's pools (or dense K/V) of its
kv heads.  The
residual rows and h0 are whole on every shard, so the shared block's
input norm over concat(h, h0) needs no reduction.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import layers, ssm, transformer
from .config import ModelConfig
from .transformer import (Shard, layer_params, shard_sum, stack_layers,
                          unbind_layers)


def _n_apps(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def _tail_layers(cfg: ModelConfig) -> int:
    return cfg.num_layers - _n_apps(cfg) * cfg.attn_every


def init_shared_block(gen: torch.Generator, cfg: ModelConfig):
    dev = gen.device
    return {"ln_a": layers.init_norm(cfg, dev, dim=2 * cfg.d_model),
            "attn": layers.init_attention(gen, cfg, d_in=2 * cfg.d_model),
            "ln_m": layers.init_norm(cfg, dev),
            "mlp": layers.init_mlp(gen, cfg)}


def init(seed: int, cfg: ModelConfig, device=None):
    """Random weights from ``seed`` on ``device`` (the card unless
    ``"cpu"``), in the reference's tree layout.  The draws differ from the
    reference's ``jax.random`` ones; tests carry reference weights over
    with ``repro_torch.bridge.params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return {"embed": layers.init_embedding(gen, cfg),
            "mamba": stack_layers([ssm.init_mamba_block(gen, cfg)
                                   for _ in range(cfg.num_layers)]),
            "shared": init_shared_block(gen, cfg),
            "ln_f": layers.init_norm(cfg, dev)}


def _split_groups(cfg: ModelConfig):
    """The reference's ``_split_groups`` as index arithmetic on the stacked
    layer axis: ([(group g's flat layer indices, g) for each application
    g], the tail's flat layer indices)."""
    napps, every = _n_apps(cfg), cfg.attn_every
    groups = [(range(g * every, (g + 1) * every), g) for g in range(napps)]
    return groups, range(napps * every, cfg.num_layers)


def _run_layers(cfg: ModelConfig, h, mamba_fn, shared_fn):
    """The layer order: each group's mamba layers ``mamba_fn(i, h)``, then
    its application ``shared_fn(g, h)``; then the tail's mamba layers."""
    groups, tail = _split_groups(cfg)
    for idx, g in groups:
        for i in idx:
            h = mamba_fn(i, h)
        h = shared_fn(g, h)
    for i in tail:
        h = mamba_fn(i, h)
    return h


def _mlp_residual(shared, cfg: ModelConfig, h):
    return h + layers.mlp(shared["mlp"], cfg,
                          layers.apply_norm(shared["ln_m"], cfg, h))


def _shared_forward(shared, cfg: ModelConfig, h, h0, *, positions, window):
    """The shared block over a whole sequence (B, L, d).  Returns (h, (k,
    v)), k and v (B, L, Hkv, D) as attended."""
    xn = layers.apply_norm(shared["ln_a"], cfg, torch.cat([h, h0], dim=-1))
    a, kv = layers.attention_with_kv(shared["attn"], cfg, xn,
                                     positions=positions, causal=True,
                                     window=window)
    return _mlp_residual(shared, cfg, h + a), kv


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------

def forward_hidden(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                   train: bool = False):
    """The final-norm hidden states (B, L, d) of ``batch["tokens"]``
    (B, L), and a zero aux loss.  With ``train`` each mamba layer runs
    under a non-reentrant checkpoint and the shared block's applications
    do not (the reference checkpoints ``mamba_body`` alone), so h0's
    gradient gathers from every application."""
    tokens = batch["tokens"]
    h0 = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=h0.device)[None]
    mamba = unbind_layers(params["mamba"], cfg.num_layers)

    def mamba_fn(i, h):
        if train:
            return checkpoint(ssm.mamba_block, mamba[i], cfg, h,
                              use_reentrant=False)
        return ssm.mamba_block(mamba[i], cfg, h)

    def shared_fn(g, h):
        return _shared_forward(params["shared"], cfg, h, h0,
                               positions=positions,
                               window=cfg.sliding_window)[0]

    h = _run_layers(cfg, h0, mamba_fn, shared_fn)
    h = layers.apply_norm(params["ln_f"], cfg, h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def logits_fn(params, cfg: ModelConfig, hidden):
    return layers.unembed(params["embed"], cfg, hidden)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """``ssm.init_cache``'s per-slot state and each application's dense
    K/V, (n_apps, B, S, Hkv, D), S = ``max_len`` (capped at the sliding
    window)."""
    dtype = dtype or cfg.compute_dtype
    base = ssm.init_cache(cfg, batch_size, max_len, dtype, device=device)
    window = cfg.sliding_window
    S = min(max_len, window) if window is not None else max_len
    shape = (_n_apps(cfg), batch_size, S, cfg.num_kv_heads, cfg.head_dim)
    dev = base["ssd"].device
    base["attn_k"] = torch.zeros(shape, dtype=dtype, device=dev)
    base["attn_v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return base


def _embed(params, cfg: ModelConfig, tokens):
    return layers.embed(params["embed"], cfg, tokens).to(cfg.compute_dtype)


def _mamba_tp(shards, cfg: ModelConfig, i: int, x, mixer, mesh):
    """Mamba layer ``i`` on every shard: each shard's mixer over its SSD
    heads (``mixer(i, shard index, layer params, x)`` -> (y, z)), then the
    gated norm and ``out_proj`` reduced over the shards
    (``ssm._gated_out_tp``)."""
    lps = [layer_params(s.params["mamba"], i) for s in shards]
    mixed = [mixer(i, j, lp, xs) for j, (lp, xs) in enumerate(zip(lps, x))]
    out = ssm._gated_out_tp(lps, cfg, [m[0] for m in mixed],
                            [m[1] for m in mixed], mesh)
    return [xs + o for xs, o in zip(x, out)]


def _shared_tp(shards, cfg: ModelConfig, g: int, h, h0, attend, mesh):
    """Application ``g`` of the shared block on every shard: each shard's
    attention over its heads (``attend(g, shard index, attention params,
    shard config, normed concat(h, h0))``) and its MLP part are partial
    sums that the mesh reduces; a whole MLP runs on each shard alone."""
    sps = [s.params["shared"] for s in shards]
    a = shard_sum(mesh, [
        attend(g, j, sp["attn"], s.cfg, layers.apply_norm(
            sp["ln_a"], cfg, torch.cat([hs, h0s], dim=-1)))
        for j, (s, sp, hs, h0s) in enumerate(zip(shards, sps, h, h0))])
    h = [hs + a_ for hs, a_ in zip(h, a)]
    m = [layers.mlp(sp["mlp"], cfg, layers.apply_norm(sp["ln_m"], cfg, hs))
         for sp, hs in zip(sps, h)]
    if shards[0].mlp_split:
        m = shard_sum(mesh, m)
    return [hs + ms for hs, ms in zip(h, m)]


def _run_layers_tp(shards, cfg: ModelConfig, h0, mixer, attend, mesh):
    """``_run_layers`` over shards: every row list one entry a shard."""
    return _run_layers(
        cfg, h0, lambda i, h: _mamba_tp(shards, cfg, i, h, mixer, mesh),
        lambda g, h: _shared_tp(shards, cfg, g, h, h0, attend, mesh))


def _chunk_mixer(caches, chunk_len, cfg: ModelConfig):
    """The chunk steps' mixer: shard j's heads of mamba layer i advanced
    by the chunk (``ssm._mixer_chunk``), its state written in place."""
    def mixer(i, j, lp, x):
        c = caches[j]
        y, z, tail, state = ssm._mixer_chunk(lp, cfg, x, c["conv"][i],
                                             c["ssd"][i], chunk_len[j])
        c["conv"][i].copy_(tail)
        c["ssd"][i].copy_(state)
        return y, z
    return mixer


def _decode_mixer(caches, live, cfg: ModelConfig):
    """The decode steps' mixer: one token through shard j's heads of
    mamba layer i, its state updated in place where ``live[j]`` (every
    slot when ``None``)."""
    def mixer(i, j, lp, x):
        return ssm._mixer_decode(lp, cfg, x, caches[j]["conv"][i],
                                 caches[j]["ssd"][i], live[j])
    return mixer


def _shard_cache(cfg: ModelConfig, shard, B: int, S: int, dtype, device):
    """A new dense cache of one shard: its SSD heads' state
    (``ssm.state_cache``) and each application's K/V of its kv heads, S
    rows."""
    H = ssm._heads(layer_params(shard.params["mamba"], 0))
    cache = ssm.state_cache(cfg, B, H, dtype, device)
    shape = (_n_apps(cfg), B, S, shard.cfg.num_kv_heads, cfg.head_dim)
    cache["attn_k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["attn_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def prefill_tp(shards, cfg: ModelConfig, tokens, cache_size, *, mesh=None):
    """One-shot prefill over ``shards`` (``tokens`` one copy a shard, on
    its device): every mamba layer is one SSD scan over the prompt a
    shard, over its heads, every application one flash attention a shard
    over its heads, the partial sums reduced by ``mesh``.  One shard
    without a mesh is the unsharded ``prefill``, op for op.  Returns
    (logits at the last position (B, V) on the first shard's device, one
    new cache a shard: its SSD heads' conv tail and state, each
    application's K/V of its kv heads in ``cache_size`` rows
    (``transformer.prefill_cache_rows``), with ``len`` L)."""
    h0 = layers.embed_tp(shards, cfg, tokens, mesh)
    B, L = h0[0].shape[:2]
    kv_size = transformer.prefill_cache_size(cfg, L, cache_size)
    caches = [_shard_cache(cfg, s, B, kv_size, hs.dtype, hs.device)
              for s, hs in zip(shards, h0)]
    positions = [torch.arange(L, device=hs.device)[None] for hs in h0]

    def mixer(i, j, lp, x):
        y, z, tail, state = ssm._mixer_full(lp, cfg, x)
        caches[j]["conv"][i].copy_(tail)
        caches[j]["ssd"][i].copy_(state)
        return y, z

    def attend(g, j, p, scfg, xn):
        a, (k, v) = layers.attention_with_kv(
            p, scfg, xn, positions=positions[j], causal=True,
            window=cfg.sliding_window)
        k, v = transformer.prefill_cache_rows(k, v, kv_size)
        caches[j]["attn_k"][g].copy_(k)
        caches[j]["attn_v"][g].copy_(v)
        return a

    h = _run_layers_tp(shards, cfg, h0, mixer, attend, mesh)
    last = [layers.apply_norm(s.params["ln_f"], cfg, hs[:, -1])
            for s, hs in zip(shards, h)]
    for c in caches:
        c["len"].fill_(L)
    return layers.unembed_tp(shards, cfg, last, mesh), caches


def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            cache_size=None):
    """One-shot prefill of ``batch["tokens"]`` (B, L): every mamba layer is
    one SSD scan over the prompt, every application one flash attention.
    Returns (logits at the last position (B, V), a new cache: each layer's
    conv tail and SSD state, each application's K/V in ``cache_size`` rows
    (``transformer.prefill_cache_rows``: zero-padded, or for a window the
    ring of its last rows) and the shared scalar ``len`` L)."""
    logits, (cache,) = prefill_tp([Shard(params, cfg)], cfg,
                                  [batch["tokens"]], cache_size)
    return logits, cache


def prefill_chunk_tp(shards, cfg: ModelConfig, tokens, caches, chunk_len, *,
                     mesh=None):
    """The dense-cache chunk over ``shards``, its arguments one entry a
    shard on the shard's device: ``caches`` each shard's state of its SSD
    heads and each application's dense K/V of its kv heads (its gathered
    dense view), all written in place.  Returns (logits at each slot's
    last real token (B, V) on the first shard's device, ``len +
    chunk_len``)."""
    h0 = layers.embed_tp(shards, cfg, tokens, mesh)
    start = [c["len"] for c in caches]

    def attend(g, j, p, scfg, xn):
        return layers.attention_chunk(
            p, scfg, xn, caches[j]["attn_k"][g], caches[j]["attn_v"][g],
            start[j], chunk_len[j], window=cfg.sliding_window)[0]

    h = _run_layers_tp(shards, cfg, h0, _chunk_mixer(caches, chunk_len, cfg),
                       attend, mesh)
    last = [layers.apply_norm(s.params["ln_f"], cfg,
                              layers.take_chunk_last(hs, cl)[:, None])[:, 0]
            for s, hs, cl in zip(shards, h, chunk_len)]
    return layers.unembed_tp(shards, cfg, last, mesh), start[0] + \
        torch.as_tensor(chunk_len[0], dtype=torch.int32, device=h0[0].device)


def prefill_chunk(params, cfg: ModelConfig, batch, cache, *, chunk_len):
    """Chunked prefill against a dense cache: a right-padded chunk of
    ``chunk_len`` <= T tokens (``batch["tokens"]`` (B, T)) advances every
    mamba layer's state in place (``ssm._mixer_chunk``) and each
    application appends its K/V rows to its own cache at ``cache["len"]``
    (scalar or (B,)), in place.  Returns (logits at each slot's last real
    token (B, V), cache with ``len + chunk_len``)."""
    logits, new_len = prefill_chunk_tp([Shard(params, cfg)], cfg,
                                       [batch["tokens"]], [cache],
                                       [chunk_len])
    return logits, {**cache, "len": new_len}


def prefill_chunk_paged_tp(shards, cfg: ModelConfig, tokens, caches,
                           block_tables, chunk_len, *, block_size: int,
                           mesh=None):
    """``prefill_chunk_paged`` over ``shards``, its arguments one entry a
    shard on the shard's device: ``caches`` each shard's ``{"conv",
    "ssd", "attn_k", "attn_v", "len"}`` (its SSD heads' state and conv
    channels, B and C whole; its kv heads' pools of every application),
    updated in place.  One shard without a mesh is the unsharded step, op
    for op.  Returns (logits at each slot's last real token (B, V) on the
    first shard's device, ``len + chunk_len``)."""
    h0 = layers.embed_tp(shards, cfg, tokens, mesh)
    start = [torch.as_tensor(c["len"], dtype=torch.int32,
                             device=xs.device).reshape(-1)
             for c, xs in zip(caches, h0)]

    def attend(g, j, p, scfg, xn):
        return layers.attention_chunk_paged(
            p, scfg, xn, caches[j]["attn_k"][g], caches[j]["attn_v"][g],
            block_tables[j], start[j], chunk_len[j], block_size=block_size,
            window=cfg.sliding_window)[0]

    h = _run_layers_tp(shards, cfg, h0, _chunk_mixer(caches, chunk_len, cfg),
                       attend, mesh)
    last = [layers.apply_norm(s.params["ln_f"], cfg,
                              layers.take_chunk_last(hs, cl)[:, None])[:, 0]
            for s, hs, cl in zip(shards, h, chunk_len)]
    return layers.unembed_tp(shards, cfg, last, mesh), start[0] + chunk_len[0]


def prefill_chunk_paged(params, cfg: ModelConfig, batch, cache,
                        block_tables, *, chunk_len, block_size: int):
    """Paged-native chunked prefill: the mamba state advances as in
    ``prefill_chunk`` (per-slot state is never paged); each application
    scatters its chunk K/V rows straight into its page pools
    ``cache["attn_k"][g]``/``cache["attn_v"][g]`` through ``block_tables``
    (B, nblk), from the per-slot offsets ``cache["len"]``, in place.
    Returns (logits at each slot's last real token (B, V), cache with
    ``len + chunk_len``)."""
    logits, new_len = prefill_chunk_paged_tp(
        [Shard(params, cfg)], cfg, [batch["tokens"]], [cache],
        [block_tables], [chunk_len], block_size=block_size)
    return logits, {**cache, "len": new_len}


def decode_step_tp(shards, cfg: ModelConfig, token, caches, live, *,
                   mesh=None):
    """``decode_step`` over ``shards``: ``token``, ``caches`` (each
    shard's state of its SSD heads and each application's dense K/V of
    its kv heads, a gathered dense view or a window ring, with its copy
    of ``len``) and ``live`` (None or (B,)) one entry a shard.  Each
    shard writes its heads' state and new rows in place.  Returns (logits
    (B, V) on the first shard's device, the new lengths, kept where a
    slot is not live)."""
    lens = [c["len"] for c in caches]
    new_len = [n + 1 for n in lens]
    live = [None if lv is None else lv.bool() for lv in live]
    h0 = layers.embed_tp(shards, cfg, token, mesh)
    S, window = caches[0]["attn_k"].shape[2], cfg.sliding_window
    # a ring of exactly the window holds only visible keys: no mask needed
    eff_window = None if (window is None or S <= window) else window

    def attend(g, j, p, scfg, xn):
        return layers.attention_decode(
            p, scfg, xn, caches[j]["attn_k"][g], caches[j]["attn_v"][g],
            new_len[j], window=eff_window, live=live[j])[0]

    h = _run_layers_tp(shards, cfg, h0, _decode_mixer(caches, live, cfg),
                       attend, mesh)
    last = [layers.apply_norm(s.params["ln_f"], cfg, hs)
            for s, hs in zip(shards, h)]
    return layers.unembed_tp(shards, cfg, last, mesh), (
        new_len[0] if live[0] is None
        else torch.where(live[0], new_len[0], lens[0]))


def decode_step(params, cfg: ModelConfig, token, cache, *, live=None):
    """Fused decode against a dense cache: ``token`` (B,) one new token a
    slot, written at ring slot ``len % S`` of each application's cache; the
    state and the caches are updated in place.  Where ``live`` (B,) is
    False a slot keeps its state, its rows and its length (the reference's
    ``merge_state`` commit).  Returns (logits (B, V), cache with the live
    slots' ``len + 1``)."""
    logits, new_len = decode_step_tp([Shard(params, cfg)], cfg, [token],
                                     [cache], [live])
    return logits, {**cache, "len": new_len}


def decode_step_paged_tp(shards, cfg: ModelConfig, token, caches,
                         block_tables, live, *, block_size: int, mesh=None):
    """``decode_step_paged`` over ``shards``, its arguments one entry a
    shard as in ``prefill_chunk_paged_tp``.  Returns (logits (B, V) on
    the first shard's device, the live slots' ``len + 1``)."""
    lens = [c["len"].to(torch.int32) for c in caches]
    live = [lv.bool() for lv in live]
    h0 = layers.embed_tp(shards, cfg, token, mesh)

    def attend(g, j, p, scfg, xn):
        return layers.attention_decode_paged(
            p, scfg, xn, caches[j]["attn_k"][g], caches[j]["attn_v"][g],
            block_tables[j], lens[j], live[j], block_size=block_size,
            window=cfg.sliding_window)[0]

    h = _run_layers_tp(shards, cfg, h0, _decode_mixer(caches, live, cfg),
                       attend, mesh)
    last = [layers.apply_norm(s.params["ln_f"], cfg, hs)
            for s, hs in zip(shards, h)]
    return (layers.unembed_tp(shards, cfg, last, mesh),
            torch.where(live[0], lens[0] + 1, lens[0]))


def decode_step_paged(params, cfg: ModelConfig, token, cache, block_tables,
                      live, *, block_size: int):
    """Paged-native fused decode: ``token`` (B,) one new token a slot,
    ``cache["len"]`` (B,) tokens already cached.  The live slots' mamba
    state advances in place; each application reads its K/V in place
    through ``block_tables`` and writes one new row a live slot (dead slots
    write to the trash page and keep their state and length).  Returns
    (logits (B, V), cache with the live slots' ``len + 1``)."""
    logits, new_len = decode_step_paged_tp(
        [Shard(params, cfg)], cfg, [token], [cache], [block_tables], [live],
        block_size=block_size)
    return logits, {**cache, "len": new_len}
