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
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import layers, ssm, transformer
from .config import ModelConfig
from .transformer import layer_params, stack_layers, unbind_layers


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


def _shared_decode(shared, cfg: ModelConfig, h_t, h0_t, k_cache, v_cache,
                   cache_len, *, window, live=None):
    """One decode token (B, d) through the shared block against one
    application's dense caches (B, S, Hkv, D), written in place."""
    S = k_cache.shape[1]
    eff_window = None if (window is None or S <= window) else window
    xcat = torch.cat([h_t, h0_t], dim=-1)
    xn = layers.apply_norm(shared["ln_a"], cfg, xcat[:, None])[:, 0]
    a, _, _ = layers.attention_decode(shared["attn"], cfg, xn, k_cache,
                                      v_cache, cache_len, window=eff_window,
                                      live=live)
    h_t = h_t + a
    xn = layers.apply_norm(shared["ln_m"], cfg, h_t[:, None])[:, 0]
    return h_t + layers.mlp(shared["mlp"], cfg, xn)


def _shared_chunk(shared, cfg: ModelConfig, h, h0, k_cache, v_cache,
                  cache_len, chunk_len, *, window):
    """Chunked-prefill pass through the shared block (the multi-token
    sibling of ``_shared_decode``)."""
    xn = layers.apply_norm(shared["ln_a"], cfg, torch.cat([h, h0], dim=-1))
    a, _, _ = layers.attention_chunk(shared["attn"], cfg, xn, k_cache,
                                     v_cache, cache_len, chunk_len,
                                     window=window)
    return _mlp_residual(shared, cfg, h + a)


def _shared_decode_paged(shared, cfg: ModelConfig, h_t, h0_t, k_pages,
                         v_pages, block_tables, lens, live, *, block_size,
                         window):
    """Paged-native ``_shared_decode``: the application's K/V stream
    through the block table; only live slots' new rows are written."""
    xcat = torch.cat([h_t, h0_t], dim=-1)
    xn = layers.apply_norm(shared["ln_a"], cfg, xcat[:, None])[:, 0]
    a, _, _ = layers.attention_decode_paged(
        shared["attn"], cfg, xn, k_pages, v_pages, block_tables, lens, live,
        block_size=block_size, window=window)
    h_t = h_t + a
    xn = layers.apply_norm(shared["ln_m"], cfg, h_t[:, None])[:, 0]
    return h_t + layers.mlp(shared["mlp"], cfg, xn)


def _shared_chunk_paged(shared, cfg: ModelConfig, h, h0, k_pages, v_pages,
                        block_tables, cache_len, chunk_len, *, block_size,
                        window):
    """Paged-native ``_shared_chunk``."""
    xn = layers.apply_norm(shared["ln_a"], cfg, torch.cat([h, h0], dim=-1))
    a, _, _ = layers.attention_chunk_paged(
        shared["attn"], cfg, xn, k_pages, v_pages, block_tables, cache_len,
        chunk_len, block_size=block_size, window=window)
    return _mlp_residual(shared, cfg, h + a)


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


def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            cache_size=None):
    """One-shot prefill of ``batch["tokens"]`` (B, L): every mamba layer is
    one SSD scan over the prompt, every application one flash attention.
    Returns (logits at the last position (B, V), a new cache: each layer's
    conv tail and SSD state, each application's K/V in ``cache_size`` rows
    (``transformer.prefill_cache_rows``: zero-padded, or for a window the
    ring of its last rows) and the shared scalar ``len`` L)."""
    tokens = batch["tokens"]
    B, L = tokens.shape
    h0 = _embed(params, cfg, tokens)
    kv_size = transformer.prefill_cache_size(cfg, L, cache_size)
    cache = init_cache(cfg, B, kv_size, dtype=h0.dtype, device=h0.device)
    positions = torch.arange(L, device=h0.device)[None]

    def mamba_fn(i, h):
        h, (tail, state) = ssm.mamba_block(layer_params(params["mamba"], i),
                                           cfg, h, return_state=True)
        cache["conv"][i].copy_(tail)
        cache["ssd"][i].copy_(state)
        return h

    def shared_fn(g, h):
        h, (k, v) = _shared_forward(params["shared"], cfg, h, h0,
                                    positions=positions,
                                    window=cfg.sliding_window)
        k, v = transformer.prefill_cache_rows(k, v, kv_size)
        cache["attn_k"][g].copy_(k)
        cache["attn_v"][g].copy_(v)
        return h

    h = _run_layers(cfg, h0, mamba_fn, shared_fn)
    h = layers.apply_norm(params["ln_f"], cfg, h[:, -1])
    cache["len"] = torch.tensor(L, dtype=torch.int32, device=h0.device)
    return logits_fn(params, cfg, h), cache


def _chunk_mamba(params, cfg: ModelConfig, cache, chunk_len):
    """The chunk steps' mamba layer: advance layer i's conv tail and SSD
    state by the chunk (``ssm.mamba_block_chunk``), written in place."""
    conv_all, ssd_all = cache["conv"], cache["ssd"]

    def mamba_fn(i, h):
        h, tail, state = ssm.mamba_block_chunk(
            layer_params(params["mamba"], i), cfg, h, conv_all[i],
            ssd_all[i], chunk_len)
        conv_all[i].copy_(tail)
        ssd_all[i].copy_(state)
        return h
    return mamba_fn


def _decode_mamba(params, cfg: ModelConfig, cache, live):
    """The decode steps' mamba layer: one token through layer i, its state
    updated in place where ``live`` (every slot when ``None``)."""
    conv_all, ssd_all = cache["conv"], cache["ssd"]

    def mamba_fn(i, h):
        return ssm.mamba_block_decode(layer_params(params["mamba"], i), cfg,
                                      h, conv_all[i], ssd_all[i], live)
    return mamba_fn


def _head(params, cfg: ModelConfig, h):
    """The final norm and the unembedding of (B, d) rows."""
    h = layers.apply_norm(params["ln_f"], cfg, h[:, None])[:, 0]
    return logits_fn(params, cfg, h)


def prefill_chunk(params, cfg: ModelConfig, batch, cache, *, chunk_len):
    """Chunked prefill against a dense cache: a right-padded chunk of
    ``chunk_len`` <= T tokens (``batch["tokens"]`` (B, T)) advances every
    mamba layer's state in place (``ssm.mamba_block_chunk``) and each
    application appends its K/V rows to its own cache at ``cache["len"]``
    (scalar or (B,)), in place.  Returns (logits at each slot's last real
    token (B, V), cache with ``len + chunk_len``)."""
    h0 = _embed(params, cfg, batch["tokens"])
    start = cache["len"]
    k_all, v_all = cache["attn_k"], cache["attn_v"]

    def shared_fn(g, h):
        return _shared_chunk(params["shared"], cfg, h, h0, k_all[g],
                             v_all[g], start, chunk_len,
                             window=cfg.sliding_window)

    h = _run_layers(cfg, h0, _chunk_mamba(params, cfg, cache, chunk_len),
                    shared_fn)
    logits = _head(params, cfg, layers.take_chunk_last(h, chunk_len))
    return logits, {**cache, "len": start + torch.as_tensor(
        chunk_len, dtype=torch.int32, device=h0.device)}


def prefill_chunk_paged(params, cfg: ModelConfig, batch, cache,
                        block_tables, *, chunk_len, block_size: int):
    """Paged-native chunked prefill: the mamba state advances as in
    ``prefill_chunk`` (per-slot state is never paged); each application
    scatters its chunk K/V rows straight into its page pools
    ``cache["attn_k"][g]``/``cache["attn_v"][g]`` through ``block_tables``
    (B, nblk), from the per-slot offsets ``cache["len"]``, in place.
    Returns (logits at each slot's last real token (B, V), cache with
    ``len + chunk_len``)."""
    h0 = _embed(params, cfg, batch["tokens"])
    start = torch.as_tensor(cache["len"], dtype=torch.int32,
                            device=h0.device).reshape(-1)
    k_all, v_all = cache["attn_k"], cache["attn_v"]

    def shared_fn(g, h):
        return _shared_chunk_paged(params["shared"], cfg, h, h0, k_all[g],
                                   v_all[g], block_tables, start, chunk_len,
                                   block_size=block_size,
                                   window=cfg.sliding_window)

    h = _run_layers(cfg, h0, _chunk_mamba(params, cfg, cache, chunk_len),
                    shared_fn)
    logits = _head(params, cfg, layers.take_chunk_last(h, chunk_len))
    return logits, {**cache, "len": start + chunk_len}


def decode_step(params, cfg: ModelConfig, token, cache, *, live=None):
    """Fused decode against a dense cache: ``token`` (B,) one new token a
    slot, written at ring slot ``len % S`` of each application's cache; the
    state and the caches are updated in place.  Where ``live`` (B,) is
    False a slot keeps its state, its rows and its length (the reference's
    ``merge_state`` commit).  Returns (logits (B, V), cache with the live
    slots' ``len + 1``)."""
    h0 = _embed(params, cfg, token)
    lens = cache["len"]
    new_len = lens + 1
    live = None if live is None else live.bool()
    k_all, v_all = cache["attn_k"], cache["attn_v"]

    def shared_fn(g, h):
        return _shared_decode(params["shared"], cfg, h, h0, k_all[g],
                              v_all[g], new_len, window=cfg.sliding_window,
                              live=live)

    h = _run_layers(cfg, h0, _decode_mamba(params, cfg, cache, live),
                    shared_fn)
    return _head(params, cfg, h), {
        **cache, "len": new_len if live is None
        else torch.where(live, new_len, lens)}


def decode_step_paged(params, cfg: ModelConfig, token, cache, block_tables,
                      live, *, block_size: int):
    """Paged-native fused decode: ``token`` (B,) one new token a slot,
    ``cache["len"]`` (B,) tokens already cached.  The live slots' mamba
    state advances in place; each application reads its K/V in place
    through ``block_tables`` and writes one new row a live slot (dead slots
    write to the trash page and keep their state and length).  Returns
    (logits (B, V), cache with the live slots' ``len + 1``)."""
    h0 = _embed(params, cfg, token)
    lens = cache["len"].to(torch.int32)
    live = live.bool()
    k_all, v_all = cache["attn_k"], cache["attn_v"]

    def shared_fn(g, h):
        return _shared_decode_paged(params["shared"], cfg, h, h0, k_all[g],
                                    v_all[g], block_tables, lens, live,
                                    block_size=block_size,
                                    window=cfg.sliding_window)

    h = _run_layers(cfg, h0, _decode_mamba(params, cfg, cache, live),
                    shared_fn)
    return _head(params, cfg, h), {
        **cache, "len": torch.where(live, lens + 1, lens)}
