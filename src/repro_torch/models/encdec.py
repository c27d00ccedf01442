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
``prefill_chunk``, ``decode_step``, ``prefill_chunk_paged`` and
``decode_step_paged``.  ``forward_hidden`` raises, naming ROADMAP.md Queue
1 item 12.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

from . import layers
from .config import ModelConfig
from .transformer import (layer_params, prefill_cache_rows,
                          prefill_cache_size, stack_layers)


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
    memory (B, T, d) in the compute dtype."""
    B, T, d = frame_embeddings.shape
    h = frame_embeddings.to(cfg.compute_dtype)
    h = h + layers.sinusoidal_positions(T, d, h.device)[None].to(h.dtype)
    for i in range(cfg.encoder_layers):
        lp = layer_params(params["enc_blocks"], i)
        h = h + layers.attention(lp["attn"], cfg,
                                 layers.apply_norm(lp["ln1"], cfg, h),
                                 causal=False)
        h = h + layers.mlp(lp["mlp"], cfg,
                           layers.apply_norm(lp["ln2"], cfg, h))
    return layers.apply_norm(params["ln_enc"], cfg, h)


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


def forward_hidden(*args, **kwargs):
    raise NotImplementedError(
        "encdec.forward_hidden is not ported to repro_torch yet: ROADMAP.md "
        "Queue 1 item 12 (training)")


def _decoder_embed(params, cfg: ModelConfig, tokens, start):
    """Token embeddings (B, T, d) plus the sinusoids of their positions
    ``start + i`` (``start`` (B,))."""
    B, T = tokens.shape
    x = layers.embed(params["embed"], cfg, tokens).to(cfg.compute_dtype)
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


def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            cache_size=None):
    """One-shot prefill: encode ``batch["embeddings"]`` (B, encoder_len, d),
    then run the decoder over ``batch["tokens"]`` (B, L).  Returns (logits
    at the last position (B, V), a new dense cache: decoder K/V of
    ``cache_size`` rows (see ``transformer.prefill_cache_rows``), each
    layer's cross K/V, and the shared scalar ``len`` L)."""
    memory = encode(params, cfg, batch["embeddings"])
    tokens = batch["tokens"]
    B, L = tokens.shape
    dev = tokens.device
    cache_size = prefill_cache_size(cfg, L, cache_size)
    x = _decoder_embed(params, cfg, tokens,
                       torch.zeros((B,), dtype=torch.int32, device=dev))
    cache = init_cache(cfg, B, cache_size, dtype=x.dtype, device=dev)
    for i in range(cfg.num_layers):
        lp = layer_params(params["dec_blocks"], i)
        h, (k, v) = layers.attention_with_kv(
            lp["self_attn"], cfg, layers.apply_norm(lp["ln1"], cfg, x),
            causal=True, window=cfg.sliding_window, use_rope=False)
        x = x + h
        h, (ck, cv) = layers.attention_with_kv(
            lp["cross_attn"], cfg, layers.apply_norm(lp["ln_x"], cfg, x),
            causal=False, kv_x=memory, use_rope=False)
        x = x + h
        x = x + layers.mlp(lp["mlp"], cfg,
                           layers.apply_norm(lp["ln2"], cfg, x))
        k, v = prefill_cache_rows(k, v, cache_size)
        for name, t in (("k", k), ("v", v), ("cross_k", ck),
                        ("cross_v", cv)):
            cache[name][i].copy_(t)
    h = layers.apply_norm(params["ln_f"], cfg, x[:, -1])
    cache["len"] = torch.tensor(L, dtype=torch.int32, device=dev)
    return logits_fn(params, cfg, h), cache


def prefill_chunk(params, cfg: ModelConfig, batch, cache, *, chunk_len):
    """Chunked decoder prefill against a dense cache (see
    ``prefill_chunk_paged``): a slot's FIRST chunk carries
    ``batch["embeddings"]``, runs the encoder and writes each layer's cross
    K/V into ``cache["cross_k"]``/``["cross_v"]`` in place; the
    self-attention appends the chunk like ``transformer.prefill_chunk``,
    one launch of the dense chunk kernel a layer.  Returns (logits at each
    slot's last real token (B, V), cache with ``len + chunk_len``)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    dev = tokens.device
    start = torch.as_tensor(cache["len"], dtype=torch.int32,
                            device=dev).expand(B)
    x = _decoder_embed(params, cfg, tokens, start)
    first = "embeddings" in batch
    memory = encode(params, cfg, batch["embeddings"]) if first else None
    k_all, v_all = cache["k"], cache["v"]
    ck_all, cv_all = cache["cross_k"], cache["cross_v"]
    for i in range(cfg.num_layers):
        lp = layer_params(params["dec_blocks"], i)
        xp = lp["cross_attn"]
        if first:                   # project this layer's cross K/V once
            _project_cross(xp, cfg, memory, ck_all[i], cv_all[i])
        a, _, _ = layers.attention_chunk(
            lp["self_attn"], cfg, layers.apply_norm(lp["ln1"], cfg, x),
            k_all[i], v_all[i], start, chunk_len, window=cfg.sliding_window,
            use_rope=False)
        x = x + a
        x = x + _cross_chunk(xp, cfg, layers.apply_norm(lp["ln_x"], cfg, x),
                             ck_all[i], cv_all[i])
        x = x + layers.mlp(lp["mlp"], cfg,
                           layers.apply_norm(lp["ln2"], cfg, x))
    h = layers.take_chunk_last(x, chunk_len)
    h = layers.apply_norm(params["ln_f"], cfg, h)
    return logits_fn(params, cfg, h), {
        "k": k_all, "v": v_all, "cross_k": ck_all, "cross_v": cv_all,
        "len": cache["len"] + torch.as_tensor(chunk_len, dtype=torch.int32,
                                              device=dev)}


def decode_step(params, cfg: ModelConfig, token, cache, *, live=None):
    """Fused decode against a dense cache: ``token`` (B,) at position
    ``cache["len"]`` (scalar or (B,)); the self-attention K/V row is
    written at ring slot ``len % S`` in place, and every slot attends to
    all ``encoder_len`` of its cross K/V rows.  Where ``live`` (B,) is
    False a slot's cache and length are kept and it attends to nothing on
    either side.  Returns (logits (B, V), cache with ``len + 1``)."""
    B = token.shape[0]
    dev = token.device
    lens = cache["len"]
    new_len = lens + 1
    x = layers.embed(params["embed"], cfg, token).to(cfg.compute_dtype)
    x = x + layers.sinusoid_at(torch.as_tensor(lens, device=dev).expand(B),
                               cfg.d_model).to(x.dtype)
    k_all, v_all = cache["k"], cache["v"]
    ck_all, cv_all = cache["cross_k"], cache["cross_v"]
    S, window = k_all.shape[2], cfg.sliding_window
    eff_window = None if (window is None or S <= window) else window
    cross_len = torch.full((B,), ck_all.shape[2], dtype=torch.int32,
                           device=dev)
    if live is not None:
        live = live.bool()
        cross_len = torch.where(live, cross_len, 0)
    for i in range(cfg.num_layers):
        lp = layer_params(params["dec_blocks"], i)
        xp = lp["cross_attn"]
        a, _, _ = layers.attention_decode(
            lp["self_attn"], cfg, layers.apply_norm(lp["ln1"], cfg, x),
            k_all[i], v_all[i], new_len, window=eff_window, use_rope=False,
            live=live)
        x = x + a
        xn = layers.apply_norm(lp["ln_x"], cfg, x)
        # no q bias here, as in the reference's decode step
        q = layers.linear(xn, xp["wq"]).reshape(B, cfg.num_heads,
                                                cfg.head_dim)
        c = ops.decode_attention(q, ck_all[i], cv_all[i], cross_len)
        x = x + layers.linear(c.reshape(B, -1), xp["wo"])
        x = x + layers.mlp(lp["mlp"], cfg,
                           layers.apply_norm(lp["ln2"], cfg, x))
    h = layers.apply_norm(params["ln_f"], cfg, x)
    return logits_fn(params, cfg, h), {
        "k": k_all, "v": v_all, "cross_k": ck_all, "cross_v": cv_all,
        "len": new_len if live is None else torch.where(live, new_len,
                                                        lens)}


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
    tokens = batch["tokens"]
    B = tokens.shape[0]
    dev = tokens.device
    start = torch.as_tensor(cache["len"], dtype=torch.int32,
                            device=dev).reshape(-1).expand(B)
    x = _decoder_embed(params, cfg, tokens, start)
    first = "embeddings" in batch
    memory = encode(params, cfg, batch["embeddings"]) if first else None
    k_all, v_all = cache["k"], cache["v"]
    ck_all, cv_all = cache["cross_k"], cache["cross_v"]
    for i in range(cfg.num_layers):
        lp = layer_params(params["dec_blocks"], i)
        xp = lp["cross_attn"]
        if first:                   # project this layer's cross K/V once
            _project_cross(xp, cfg, memory, ck_all[i], cv_all[i])
        xn = layers.apply_norm(lp["ln1"], cfg, x)
        a, _, _ = layers.attention_chunk_paged(
            lp["self_attn"], cfg, xn, k_all[i], v_all[i], block_tables,
            start, chunk_len, block_size=block_size,
            window=cfg.sliding_window, use_rope=False)
        x = x + a
        x = x + _cross_chunk(xp, cfg, layers.apply_norm(lp["ln_x"], cfg, x),
                             ck_all[i], cv_all[i])
        x = x + layers.mlp(lp["mlp"], cfg,
                           layers.apply_norm(lp["ln2"], cfg, x))
    h = layers.take_chunk_last(x, chunk_len)
    h = layers.apply_norm(params["ln_f"], cfg, h[:, None])[:, 0]
    return logits_fn(params, cfg, h), {
        "k": k_all, "v": v_all, "cross_k": ck_all, "cross_v": cv_all,
        "len": start + torch.as_tensor(chunk_len, dtype=torch.int32,
                                       device=dev)}


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
    B = token.shape[0]
    lens = cache["len"].to(torch.int32)
    live = live.bool()
    x = layers.embed(params["embed"], cfg, token).to(cfg.compute_dtype)
    x = x + layers.sinusoid_at(lens, cfg.d_model).to(x.dtype)
    k_all, v_all = cache["k"], cache["v"]
    ck_all, cv_all = cache["cross_k"], cache["cross_v"]
    cross_len = torch.where(live, ck_all.shape[2], 0).to(torch.int32)
    for i in range(cfg.num_layers):
        lp = layer_params(params["dec_blocks"], i)
        xp = lp["cross_attn"]
        xn = layers.apply_norm(lp["ln1"], cfg, x)
        a, _, _ = layers.attention_decode_paged(
            lp["self_attn"], cfg, xn, k_all[i], v_all[i], block_tables,
            lens, live, block_size=block_size, window=cfg.sliding_window,
            use_rope=False)
        x = x + a
        xn = layers.apply_norm(lp["ln_x"], cfg, x)
        # no q bias here, as in the reference's decode step
        q = layers.linear(xn, xp["wq"]).reshape(B, cfg.num_heads,
                                                cfg.head_dim)
        c = ops.decode_attention(q, ck_all[i], cv_all[i], cross_len)
        x = x + layers.linear(c.reshape(B, -1), xp["wo"])
        x = x + layers.mlp(lp["mlp"], cfg,
                           layers.apply_norm(lp["ln2"], cfg, x))
    h = layers.apply_norm(params["ln_f"], cfg, x)
    return logits_fn(params, cfg, h), {
        "k": k_all, "v": v_all, "cross_k": ck_all, "cross_v": cv_all,
        "len": torch.where(live, lens + 1, lens)}
