"""Whisper-large-v3 backbone (encoder-decoder): the serving entry points.

As in the reference, the modality frontend (mel spectrogram and conv
feature extractor) is a stub: requests carry precomputed frame embeddings
(encoder_len, d_model).  A non-causal encoder stack turns them into memory;
a causal decoder with self- and cross-attention consumes it.  Positions
are parameter-free sinusoids on both sides (the reference's divergence
from whisper's learned decoder positions).

Parameters keep the reference's tree and stacked layer axes
(``enc_blocks``, ``dec_blocks``); its ``lax.scan`` over layers becomes a
Python loop.  The serving cache is ``{"k", "v"}``, the decoder
self-attention K/V: the arena's page pools (``(layers, pages, block_size,
Hkv, D)``, a tensor or ``QuantPages``) for the paged-native steps, a dense
``(layers, B, S, Hkv, D)`` cache for the dense ones; ``{"cross_k",
"cross_v"}``, per-slot state ``(layers, B, encoder_len, Hkv, D)`` that
does not grow with the token budget; and ``"len"``.  The steps update the
caches and cross state IN PLACE and return the same tensors (the one-shot
``prefill`` builds its cache).

Ported: ``init``, ``encode``, ``logits_fn``, ``init_cache``, ``prefill``,
``prefill_chunk``, ``decode_step``, ``prefill_chunk_paged``,
``decode_step_paged`` and the training forward ``forward_hidden`` (the
encoder once, each decoder layer checkpointed, as in the reference).
Each serving step is its ``*_tp`` function over one shard, the whole
tree; ``tp`` head shards run the head-sharded step (``launch/steps.py``
``paged_decode_builder``), the frames reaching every shard.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

from . import layers
from .config import ModelConfig
from .transformer import (Shard, layer_params, prefill_cache_rows,
                          prefill_cache_size, shard_sum, stack_layers,
                          unbind_layers)


def init_encoder_block(gen: torch.Generator, cfg: ModelConfig):
    dev = gen.device
    return {"ln1": layers.init_norm(cfg, dev),
            "attn": layers.init_attention(gen, cfg),
            "ln2": layers.init_norm(cfg, dev),
            "mlp": layers.init_mlp(gen, cfg)}


def init_decoder_block(gen: torch.Generator, cfg: ModelConfig):
    dev = gen.device
    return {"ln1": layers.init_norm(cfg, dev),
            "self_attn": layers.init_attention(gen, cfg),
            "ln_x": layers.init_norm(cfg, dev),
            "cross_attn": layers.init_attention(gen, cfg, cross=True),
            "ln2": layers.init_norm(cfg, dev),
            "mlp": layers.init_mlp(gen, cfg)}


def init(seed: int, cfg: ModelConfig, device=None):
    """Random weights from ``seed`` on ``device`` (the card unless
    ``"cpu"``), in the reference's tree layout.  The draws differ from the
    reference's ``jax.random`` ones; tests carry reference weights over
    with ``repro_torch.bridge.params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return {
        "embed": layers.init_embedding(gen, cfg),
        "enc_blocks": stack_layers([init_encoder_block(gen, cfg)
                                    for _ in range(cfg.encoder_layers)]),
        "ln_enc": layers.init_norm(cfg, dev),
        "dec_blocks": stack_layers([init_decoder_block(gen, cfg)
                                    for _ in range(cfg.num_layers)]),
        "ln_f": layers.init_norm(cfg, dev),
    }


def encode(params, cfg: ModelConfig, frame_embeddings):
    """frame_embeddings (B, T, d), the stub frontend's output -> encoder
    memory (B, T, d) in the compute dtype: one shard of ``_encode_tp``."""
    return _encode_tp([Shard(params, cfg)], cfg, [frame_embeddings],
                      None)[0]


def logits_fn(params, cfg: ModelConfig, hidden):
    return layers.unembed(params["embed"], cfg, hidden)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """A dense cache: decoder K/V (layers, B, S, Hkv, D) and the cross K/V
    (layers, B, encoder_len, Hkv, D).  The serving arena probes it on the
    ``meta`` device: it pages ``k``/``v`` and keeps the cross K/V, which do
    not grow with ``max_len``, as per-slot state."""
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    window = cfg.sliding_window
    S = min(max_len, window) if window is not None else max_len
    kv = (cfg.num_layers, batch_size, S, cfg.num_kv_heads, cfg.head_dim)
    xkv = (cfg.num_layers, batch_size, cfg.encoder_len, cfg.num_kv_heads,
           cfg.head_dim)
    zeros = lambda shape: torch.zeros(shape, dtype=dtype, device=dev)
    return {"k": zeros(kv), "v": zeros(kv), "cross_k": zeros(xkv),
            "cross_v": zeros(xkv),
            "len": torch.zeros((), dtype=torch.int32, device=dev)}


def _decoder_layer(lp, cfg: ModelConfig, x, memory):
    """One decoder layer over a whole sequence: causal self-attention
    without rope, cross-attention over the encoder memory, the MLP."""
    a, _ = layers.attention_with_kv(lp["self_attn"], cfg,
                                    layers.apply_norm(lp["ln1"], cfg, x),
                                    causal=True, window=cfg.sliding_window,
                                    use_rope=False)
    x = x + a
    x = x + layers.attention(lp["cross_attn"], cfg,
                             layers.apply_norm(lp["ln_x"], cfg, x),
                             causal=False, kv_x=memory)
    return x + layers.mlp(lp["mlp"], cfg, layers.apply_norm(lp["ln2"], cfg, x))


def forward_hidden(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                   train: bool = False):
    """The teacher-forced decoder's final-norm hidden states (B, L, d) over
    ``batch["tokens"]`` (B, L) given the stub frame embeddings
    ``batch["embeddings"]`` (B, encoder_len, d), and a zero aux loss.  The
    encoder runs once, not checkpointed; with ``train`` each decoder layer
    runs under a non-reentrant checkpoint, as in the reference."""
    memory = encode(params, cfg, batch["embeddings"])
    tokens = batch["tokens"]
    h = _decoder_embed(params, cfg, tokens, torch.zeros(
        tokens.shape[0], dtype=torch.long, device=tokens.device))
    for lp in unbind_layers(params["dec_blocks"], cfg.num_layers):
        h = (checkpoint(_decoder_layer, lp, cfg, h, memory,
                        use_reentrant=False)
             if train else _decoder_layer(lp, cfg, h, memory))
    h = layers.apply_norm(params["ln_f"], cfg, h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def _decoder_embed(params, cfg: ModelConfig, tokens, start):
    """Token embeddings (B, T, d) plus the sinusoids of their positions
    ``start + i`` (``start`` (B,))."""
    x = layers.embed(params["embed"], cfg, tokens).to(cfg.compute_dtype)
    return _add_positions(cfg, x, start)


def _add_positions(cfg: ModelConfig, x, start):
    """Embedded rows x (B, T, d) plus the sinusoids of their positions
    ``start + i`` (``start`` (B,))."""
    B, T = x.shape[:2]
    pos = (start[:, None] + torch.arange(T, device=x.device)[None])
    return x + layers.sinusoid_at(pos.reshape(-1), cfg.d_model).reshape(
        B, T, cfg.d_model).to(x.dtype)


def _project_cross(xp, cfg: ModelConfig, memory, ck, cv) -> None:
    """Write one layer's cross K/V, projected from the encoder memory and
    cast to the state's dtype, into ``ck``/``cv`` in place."""
    B, Lk = memory.shape[:2]
    H, D = cfg.num_kv_heads, cfg.head_dim
    ck.copy_(layers.linear(memory, xp["wk"], xp.get("bk")).reshape(
        B, Lk, H, D).to(ck.dtype))
    cv.copy_(layers.linear(memory, xp["wv"], xp.get("bv")).reshape(
        B, Lk, H, D).to(cv.dtype))


def _cross_chunk(xp, cfg: ModelConfig, xn, ck, cv):
    """A chunk's cross-attention (B, T, d) over one layer's cross K/V."""
    B, T = xn.shape[:2]
    q = layers.linear(xn, xp["wq"], xp.get("bq")).reshape(
        B, T, cfg.num_heads, cfg.head_dim)
    c = ops.flash_attention(q, ck, cv, causal=False)
    return layers.linear(c.reshape(B, T, -1), xp["wo"])


def prefill_tp(shards, cfg: ModelConfig, tokens, cache_size, *, mesh=None,
               embeddings):
    """One-shot prefill over head shards (``transformer.Shard``s;
    ``tokens`` and the frame ``embeddings`` one copy a shard, on its
    device): the encoder runs over the shards (``_encode_tp``), then the
    decoder, each shard's self- and cross-attention over its heads and
    its MLP part partial sums that ``mesh`` reduces.  One shard without a
    mesh is the unsharded ``prefill``, op for op.  Returns (logits at the
    last position (B, V) on the first shard's device, one new dense cache
    a shard: its kv heads' decoder K/V of ``cache_size`` rows (see
    ``transformer.prefill_cache_rows``) and cross K/V, with ``len`` L)."""
    memory = _encode_tp(shards, cfg, embeddings, mesh)
    B, L = tokens[0].shape
    cache_size = prefill_cache_size(cfg, L, cache_size)
    x = [_add_positions(cfg, xs, torch.zeros((B,), dtype=torch.int32,
                                             device=xs.device))
         for xs in layers.embed_tp(shards, cfg, tokens, mesh)]
    caches = [init_cache(s.cfg, B, cache_size, dtype=xs.dtype,
                         device=xs.device) for s, xs in zip(shards, x)]
    for i in range(cfg.num_layers):
        lps = [layer_params(s.params["dec_blocks"], i) for s in shards]
        self_kv = [layers.attention_with_kv(
            lp["self_attn"], s.cfg, layers.apply_norm(lp["ln1"], cfg, xs),
            causal=True, window=cfg.sliding_window, use_rope=False)
            for s, lp, xs in zip(shards, lps, x)]
        a = shard_sum(mesh, [h for h, _ in self_kv])
        x = [xs + a_ for xs, a_ in zip(x, a)]
        cross_kv = [layers.attention_with_kv(
            lp["cross_attn"], s.cfg, layers.apply_norm(lp["ln_x"], cfg, xs),
            causal=False, kv_x=mem, use_rope=False)
            for s, lp, xs, mem in zip(shards, lps, x, memory)]
        a = shard_sum(mesh, [h for h, _ in cross_kv])
        x = [xs + a_ for xs, a_ in zip(x, a)]
        x = _mlp_tp(shards, cfg, lps, x, mesh)
        for c, (_, (k, v)), (_, (ck, cv)) in zip(caches, self_kv, cross_kv):
            k, v = prefill_cache_rows(k, v, cache_size)
            for name, t in (("k", k), ("v", v), ("cross_k", ck),
                            ("cross_v", cv)):
                c[name][i].copy_(t)
    h = [layers.apply_norm(s.params["ln_f"], cfg, xs[:, -1])
         for s, xs in zip(shards, x)]
    for c, xs in zip(caches, x):
        c["len"] = torch.tensor(L, dtype=torch.int32, device=xs.device)
    return layers.unembed_tp(shards, cfg, h, mesh), caches


def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            cache_size=None):
    """One-shot prefill: encode ``batch["embeddings"]`` (B, encoder_len, d),
    then run the decoder over ``batch["tokens"]`` (B, L).  Returns (logits
    at the last position (B, V), a new dense cache: decoder K/V of
    ``cache_size`` rows (see ``transformer.prefill_cache_rows``), each
    layer's cross K/V, and the shared scalar ``len`` L)."""
    logits, (cache,) = prefill_tp(
        [Shard(params, cfg)], cfg, [batch["tokens"]], cache_size,
        embeddings=[batch["embeddings"]])
    return logits, cache


def prefill_chunk_tp(shards, cfg: ModelConfig, tokens, caches, chunk_len, *,
                     mesh=None, embeddings=None):
    """The dense-cache chunk over head shards, its arguments one entry a
    shard on the shard's device: ``caches`` each shard's dense cache of
    its kv heads (its gathered dense view) and its heads' cross K/V,
    written in place.  A first chunk's ``embeddings`` (one copy a shard)
    run the encoder over the shards, and each shard projects its heads'
    cross K/V from the memory into its cache.  Returns (logits at each
    slot's last real token (B, V) on the first shard's device, ``len +
    chunk_len``)."""
    B = tokens[0].shape[0]
    start = [torch.as_tensor(c["len"], dtype=torch.int32,
                             device=t.device).expand(B)
             for c, t in zip(caches, tokens)]
    x = [_add_positions(cfg, xs, st) for xs, st in
         zip(layers.embed_tp(shards, cfg, tokens, mesh), start)]
    memory = (None if embeddings is None
              else _encode_tp(shards, cfg, embeddings, mesh))
    for i in range(cfg.num_layers):
        lps = [layer_params(s.params["dec_blocks"], i) for s in shards]
        if memory is not None:      # project this layer's cross K/V once
            for s, lp, mem, c in zip(shards, lps, memory, caches):
                _project_cross(lp["cross_attn"], s.cfg, mem, c["cross_k"][i],
                               c["cross_v"][i])
        a = shard_sum(mesh, [layers.attention_chunk(
            lp["self_attn"], s.cfg, layers.apply_norm(lp["ln1"], cfg, xs),
            c["k"][i], c["v"][i], st, cl, window=cfg.sliding_window,
            use_rope=False)[0]
            for s, lp, xs, c, st, cl in zip(shards, lps, x, caches, start,
                                            chunk_len)])
        x = [xs + a_ for xs, a_ in zip(x, a)]
        a = shard_sum(mesh, [
            _cross_chunk(lp["cross_attn"], s.cfg,
                         layers.apply_norm(lp["ln_x"], cfg, xs),
                         c["cross_k"][i], c["cross_v"][i])
            for s, lp, xs, c in zip(shards, lps, x, caches)])
        x = [xs + a_ for xs, a_ in zip(x, a)]
        x = _mlp_tp(shards, cfg, lps, x, mesh)
    h = [layers.apply_norm(s.params["ln_f"], cfg,
                           layers.take_chunk_last(xs, cl))
         for s, xs, cl in zip(shards, x, chunk_len)]
    return layers.unembed_tp(shards, cfg, h, mesh), caches[0]["len"] + \
        torch.as_tensor(chunk_len[0], dtype=torch.int32,
                        device=x[0].device)


def prefill_chunk(params, cfg: ModelConfig, batch, cache, *, chunk_len):
    """Chunked decoder prefill against a dense cache (see
    ``prefill_chunk_paged``): a slot's FIRST chunk carries
    ``batch["embeddings"]``, runs the encoder and writes each layer's cross
    K/V into ``cache["cross_k"]``/``["cross_v"]`` in place; the
    self-attention appends the chunk like ``transformer.prefill_chunk``,
    one launch of the dense chunk kernel a layer.  Returns (logits at each
    slot's last real token (B, V), cache with ``len + chunk_len``)."""
    emb = batch.get("embeddings")
    logits, new_len = prefill_chunk_tp(
        [Shard(params, cfg)], cfg, [batch["tokens"]], [cache], [chunk_len],
        embeddings=None if emb is None else [emb])
    return logits, {**cache, "len": new_len}


def decode_step_tp(shards, cfg: ModelConfig, token, caches, live, *,
                   mesh=None):
    """``decode_step`` over head shards: ``token``, ``caches`` (each
    shard's dense cache of its kv heads, a gathered dense view, and its
    heads' cross K/V, with its copy of ``len``) and ``live`` (None or
    (B,)) one entry a shard.  Each shard writes its heads' new row in
    place.  Returns (logits (B, V) on the first shard's device, the new
    lengths, kept where a slot is not live)."""
    B = token[0].shape[0]
    lens = [c["len"] for c in caches]
    new_len = [n + 1 for n in lens]
    x = [xs + layers.sinusoid_at(torch.as_tensor(n, device=xs.device).expand(
        B), cfg.d_model).to(xs.dtype)
        for xs, n in zip(layers.embed_tp(shards, cfg, token, mesh), lens)]
    S, window = caches[0]["k"].shape[2], cfg.sliding_window
    eff_window = None if (window is None or S <= window) else window
    live = [None if lv is None else lv.bool() for lv in live]
    cross_len = []
    for c, lv, xs in zip(caches, live, x):
        cl = torch.full((B,), c["cross_k"].shape[2], dtype=torch.int32,
                        device=xs.device)
        cross_len.append(cl if lv is None else torch.where(lv, cl, 0))
    for i in range(cfg.num_layers):
        lps = [layer_params(s.params["dec_blocks"], i) for s in shards]
        a = shard_sum(mesh, [layers.attention_decode(
            lp["self_attn"], s.cfg, layers.apply_norm(lp["ln1"], cfg, xs),
            c["k"][i], c["v"][i], nl, window=eff_window, use_rope=False,
            live=lv)[0]
            for s, lp, xs, c, nl, lv in zip(shards, lps, x, caches, new_len,
                                            live)])
        x = [xs + a_ for xs, a_ in zip(x, a)]
        a = shard_sum(mesh, [
            _cross_decode(lp["cross_attn"], s.cfg,
                          layers.apply_norm(lp["ln_x"], cfg, xs),
                          c["cross_k"][i], c["cross_v"][i], cl)
            for s, lp, xs, c, cl in zip(shards, lps, x, caches, cross_len)])
        x = [xs + a_ for xs, a_ in zip(x, a)]
        x = _mlp_tp(shards, cfg, lps, x, mesh)
    h = [layers.apply_norm(s.params["ln_f"], cfg, xs)
         for s, xs in zip(shards, x)]
    return layers.unembed_tp(shards, cfg, h, mesh), (
        new_len[0] if live[0] is None
        else torch.where(live[0], new_len[0], lens[0]))


def decode_step(params, cfg: ModelConfig, token, cache, *, live=None):
    """Fused decode against a dense cache: ``token`` (B,) at position
    ``cache["len"]`` (scalar or (B,)); the self-attention K/V row is
    written at ring slot ``len % S`` in place, and every slot attends to
    all ``encoder_len`` of its cross K/V rows.  Where ``live`` (B,) is
    False a slot's cache and length are kept and it attends to nothing on
    either side.  Returns (logits (B, V), cache with ``len + 1``)."""
    logits, new_len = decode_step_tp([Shard(params, cfg)], cfg, [token],
                                     [cache], [live])
    return logits, {**cache, "len": new_len}


def _encode_tp(shards, cfg: ModelConfig, frames, mesh):
    """The encoder over head shards (``transformer.Shard``s; ``frames``
    one copy a shard, on its device): each shard's attention over its
    heads and its MLP columns give partial sums that ``mesh`` reduces;
    the LayerNorms run whole on every shard.  Returns the memory, one
    copy a shard.  One shard without a mesh is the unsharded encoder
    (``encode``); its layers are ``unbind_layers`` views, so training's
    backward stacks each leaf's gradients once."""
    h = []
    for f in frames:
        B, T, d = f.shape
        hs = f.to(cfg.compute_dtype)
        h.append(hs + layers.sinusoidal_positions(T, d, hs.device)[None].to(
            hs.dtype))
    per = [unbind_layers(s.params["enc_blocks"], cfg.encoder_layers)
           for s in shards]
    for i in range(cfg.encoder_layers):
        lps = [p[i] for p in per]
        a = shard_sum(mesh, [
            layers.attention(lp["attn"], s.cfg,
                             layers.apply_norm(lp["ln1"], cfg, hs),
                             causal=False)
            for s, lp, hs in zip(shards, lps, h)])
        h = [hs + a_ for hs, a_ in zip(h, a)]
        h = _mlp_tp(shards, cfg, lps, h, mesh)
    return [layers.apply_norm(s.params["ln_enc"], cfg, hs)
            for s, hs in zip(shards, h)]


def _mlp_tp(shards, cfg: ModelConfig, lps, x, mesh):
    """The residual rows ``x`` (one copy a shard) plus each shard's MLP
    (its columns and rows, reduced by ``mesh``, or the whole MLP)."""
    m = [layers.mlp(lp["mlp"], cfg, layers.apply_norm(lp["ln2"], cfg, xs))
         for lp, xs in zip(lps, x)]
    if shards[0].mlp_split:
        m = shard_sum(mesh, m)
    return [xs + ms for xs, ms in zip(x, m)]


def _cross_decode(xp, cfg: ModelConfig, xn, ck, cv, cross_len):
    """A decode token's cross-attention (B, d) over one layer's cross K/V
    of ``cfg``'s heads (no q bias, as in the reference's decode step)."""
    B = xn.shape[0]
    q = layers.linear(xn, xp["wq"]).reshape(B, cfg.num_heads, cfg.head_dim)
    c = ops.decode_attention(q, ck, cv, cross_len)
    return layers.linear(c.reshape(B, -1), xp["wo"])


def prefill_chunk_paged_tp(shards, cfg: ModelConfig, tokens, caches,
                           block_tables, chunk_len, *, block_size: int,
                           mesh=None, embeddings=None):
    """``prefill_chunk_paged`` over head shards (``transformer.Shard``s),
    its arguments one entry a shard, on the shard's device: ``caches``
    each shard's pools of its kv heads and its heads' cross K/V state.  A
    first chunk's ``embeddings`` (one copy a shard) run the encoder over
    the shards (``_encode_tp``), and each shard projects its heads' cross
    K/V from the memory into its state.  Self- and cross-attention and the
    MLP give partial sums that ``mesh`` reduces.  Returns (logits at each
    slot's last real token (B, V) on the first shard's device, ``len +
    chunk_len``)."""
    B = tokens[0].shape[0]
    start = [torch.as_tensor(c["len"], dtype=torch.int32,
                             device=t.device).reshape(-1).expand(B)
             for c, t in zip(caches, tokens)]
    x = [_add_positions(cfg, xs, st) for xs, st in
         zip(layers.embed_tp(shards, cfg, tokens, mesh), start)]
    memory = (None if embeddings is None
              else _encode_tp(shards, cfg, embeddings, mesh))
    for i in range(cfg.num_layers):
        lps = [layer_params(s.params["dec_blocks"], i) for s in shards]
        if memory is not None:      # project this layer's cross K/V once
            for s, lp, mem, c in zip(shards, lps, memory, caches):
                _project_cross(lp["cross_attn"], s.cfg, mem, c["cross_k"][i],
                               c["cross_v"][i])
        a = shard_sum(mesh, [layers.attention_chunk_paged(
            lp["self_attn"], s.cfg, layers.apply_norm(lp["ln1"], cfg, xs),
            c["k"][i], c["v"][i], bt, st, cl, block_size=block_size,
            window=cfg.sliding_window, use_rope=False)[0]
            for s, lp, xs, c, bt, st, cl in zip(
                shards, lps, x, caches, block_tables, start, chunk_len)])
        x = [xs + a_ for xs, a_ in zip(x, a)]
        a = shard_sum(mesh, [
            _cross_chunk(lp["cross_attn"], s.cfg,
                         layers.apply_norm(lp["ln_x"], cfg, xs),
                         c["cross_k"][i], c["cross_v"][i])
            for s, lp, xs, c in zip(shards, lps, x, caches)])
        x = [xs + a_ for xs, a_ in zip(x, a)]
        x = _mlp_tp(shards, cfg, lps, x, mesh)
    h = [layers.apply_norm(s.params["ln_f"], cfg,
                           layers.take_chunk_last(xs, cl)[:, None])[:, 0]
         for s, xs, cl in zip(shards, x, chunk_len)]
    return (layers.unembed_tp(shards, cfg, h, mesh),
            start[0] + torch.as_tensor(chunk_len[0], dtype=torch.int32,
                                       device=start[0].device))


def prefill_chunk_paged(params, cfg: ModelConfig, batch, cache,
                        block_tables, *, chunk_len, block_size: int):
    """Paged-native chunked decoder prefill: append a right-padded chunk of
    ``chunk_len`` <= T tokens (``batch["tokens"]`` (B, T)) to the page pools
    through ``block_tables`` (B, nblk), at the per-slot offsets
    ``cache["len"]``.  A slot's FIRST chunk carries
    ``batch["embeddings"]`` (B, encoder_len, d): it runs the encoder once
    and writes each layer's cross K/V, projected from the memory and cast
    to the state's dtype, into ``cache["cross_k"]``/``["cross_v"]`` in
    place; later chunks read them.  Returns (logits at each slot's last
    real token (B, V), cache with ``len + chunk_len``)."""
    emb = batch.get("embeddings")
    logits, new_len = prefill_chunk_paged_tp(
        [Shard(params, cfg)], cfg, [batch["tokens"]], [cache],
        [block_tables], [chunk_len], block_size=block_size,
        embeddings=None if emb is None else [emb])
    return logits, {**cache, "len": new_len}


def decode_step_paged_tp(shards, cfg: ModelConfig, token, caches,
                         block_tables, live, *, block_size: int, mesh=None):
    """``decode_step_paged`` over head shards, its arguments one entry a
    shard as in ``prefill_chunk_paged_tp``: each shard attends over its
    kv heads' pools and cross K/V.  Returns (logits (B, V) on the first
    shard's device, the live slots' ``len + 1``)."""
    lens = [c["len"].to(torch.int32) for c in caches]
    live = [lv.bool() for lv in live]
    x = [xs + layers.sinusoid_at(ln, cfg.d_model).to(xs.dtype)
         for xs, ln in zip(layers.embed_tp(shards, cfg, token, mesh), lens)]
    cross_len = [torch.where(lv, c["cross_k"].shape[2], 0).to(torch.int32)
                 for lv, c in zip(live, caches)]
    for i in range(cfg.num_layers):
        lps = [layer_params(s.params["dec_blocks"], i) for s in shards]
        a = shard_sum(mesh, [layers.attention_decode_paged(
            lp["self_attn"], s.cfg, layers.apply_norm(lp["ln1"], cfg, xs),
            c["k"][i], c["v"][i], bt, ln, lv, block_size=block_size,
            window=cfg.sliding_window, use_rope=False)[0]
            for s, lp, xs, c, bt, ln, lv in zip(
                shards, lps, x, caches, block_tables, lens, live)])
        x = [xs + a_ for xs, a_ in zip(x, a)]
        a = shard_sum(mesh, [
            _cross_decode(lp["cross_attn"], s.cfg,
                          layers.apply_norm(lp["ln_x"], cfg, xs),
                          c["cross_k"][i], c["cross_v"][i], cl)
            for s, lp, xs, c, cl in zip(shards, lps, x, caches, cross_len)])
        x = [xs + a_ for xs, a_ in zip(x, a)]
        x = _mlp_tp(shards, cfg, lps, x, mesh)
    h = [layers.apply_norm(s.params["ln_f"], cfg, xs)
         for s, xs in zip(shards, x)]
    return (layers.unembed_tp(shards, cfg, h, mesh),
            torch.where(live[0], lens[0] + 1, lens[0]))


def decode_step_paged(params, cfg: ModelConfig, token, cache, block_tables,
                      live, *, block_size: int):
    """Paged-native fused decode: ``token`` (B,) one new token per slot at
    position ``cache["len"]`` (B,).  Self-attention reads K/V in place
    through ``block_tables`` and writes only the live slots' new rows;
    cross-attention reads each live slot's ``encoder_len`` cross K/V rows.
    Dead slots attend to nothing on either side (length 0: their outputs
    are thrown away, and the kernel skips their 7.68 MB of cross K/V a
    layer at whisper-large-v3's width) and keep their length.  Returns
    (logits (B, V), cache with the live slots' ``len + 1``)."""
    logits, new_len = decode_step_paged_tp(
        [Shard(params, cfg)], cfg, [token], [cache], [block_tables], [live],
        block_size=block_size)
    return logits, {**cache, "len": new_len}
