"""Dense decoder-only transformer (llama/mistral/qwen/minicpm families):
the training forward and the serving entry points.

Parameters keep the reference's stacked layer axis: every leaf under
``params["blocks"]`` has a leading ``num_layers`` axis, and the reference's
``lax.scan`` over layers becomes a Python loop over that axis.

Two cache layouts, as in the reference.  The paged-native steps
(``prefill_chunk_paged``, ``verify_step_paged``, ``decode_step_paged``)
take the serving arena's page pools ``(layers, pages, block_size, Hkv,
D)`` (a tensor, or ``QuantPages`` for int8).  The dense steps
(``prefill``, ``prefill_chunk``, ``decode_step``) take a dense cache
``(layers, B, S, Hkv, D)``: the sync and dense-cache engines' own caches,
the arena's gathered dense view, or a ring of the last ``sliding_window``
tokens where the window is shorter than the slot budget.  Every step but
the one-shot ``prefill``, which builds its cache, updates the cache it is
given in place and returns the same tensors.

The MoE family (``moe.py``) runs the same steps with its expert FFN in
place of the MLP: ``prefill_ffn``, ``prefill_chunk_ffn``,
``decode_step_ffn``, ``prefill_chunk_paged_ffn`` and
``verify_step_paged_ffn`` take the block's FFN as ``ffn(layer params,
cfg, x)``.

``verify_step_paged`` is speculative decoding's one fused verify pass:
``prefill_chunk_paged``'s body with the head over every chunk position.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import layers
from .config import ModelConfig


def layer_params(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def unbind_layers(tree, n: int):
    """The ``n`` layers of a stacked parameter tree as a list of trees of
    views, one ``torch.unbind`` per leaf.  Under autograd each leaf's
    backward is then one ``stack`` of the layers' gradients, where ``n``
    ``tree[i]`` selects would each add a full-size zero gradient of the
    stacked leaf."""
    if isinstance(tree, dict):
        per = {k: unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return torch.unbind(tree, 0)


def init_block(gen: torch.Generator, cfg: ModelConfig):
    dev = gen.device
    return {"ln1": layers.init_norm(cfg, dev),
            "attn": layers.init_attention(gen, cfg),
            "ln2": layers.init_norm(cfg, dev),
            "mlp": layers.init_mlp(gen, cfg)}


def stack_layers(trees):
    """Stack per-layer parameter trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: stack_layers([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init(seed: int, cfg: ModelConfig, device=None):
    """Random weights from ``seed`` on ``device`` (the card unless
    ``"cpu"``), in the reference's tree layout.  The draws differ from the
    reference's ``jax.random`` ones; tests carry reference weights over
    with ``repro_torch.bridge.params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return {"embed": layers.init_embedding(gen, cfg),
            "blocks": stack_layers([init_block(gen, cfg)
                                    for _ in range(cfg.num_layers)]),
            "ln_f": layers.init_norm(cfg, dev)}


def dense_ffn(lp, cfg: ModelConfig, x):
    """The dense block's FFN: its MLP on the normed residual."""
    return layers.mlp(lp["mlp"], cfg, x)


def block_forward(p, cfg: ModelConfig, x, *, positions, window,
                  prefix_len):
    h, _ = layers.attention_with_kv(p["attn"], cfg,
                                    layers.apply_norm(p["ln1"], cfg, x),
                                    positions=positions, causal=True,
                                    window=window, prefix_len=prefix_len)
    x = x + h
    return x + layers.mlp(p["mlp"], cfg, layers.apply_norm(p["ln2"], cfg, x))


def forward_hidden(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                   train: bool = False):
    """The final-norm hidden states (B, L, d) of ``batch["tokens"]``
    (B, L), and the auxiliary loss (a zero: dense models have none).  With
    ``train`` each layer runs under a non-reentrant checkpoint (the
    reference's ``jax.checkpoint`` of the scan body): its activations are
    recomputed in the backward, flash attention's forward kernel
    included."""
    tokens = batch["tokens"]
    h = layers.embed(params["embed"], cfg, tokens).to(cfg.compute_dtype)
    kw = dict(positions=torch.arange(tokens.shape[1], device=h.device)[None],
              window=cfg.sliding_window, prefix_len=0)
    for lp in unbind_layers(params["blocks"], cfg.num_layers):
        if train:
            h = checkpoint(block_forward, lp, cfg, h, use_reentrant=False,
                           **kw)
        else:
            h = block_forward(lp, cfg, h, **kw)
    h = layers.apply_norm(params["ln_f"], cfg, h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def logits_fn(params, cfg: ModelConfig, hidden):
    return layers.unembed(params["embed"], cfg, hidden)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """A dense (layers, B, S, Hkv, D) cache; the serving arena probes it on
    the ``meta`` device to learn which leaves it pages."""
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    window = cfg.sliding_window
    S = min(max_len, window) if window is not None else max_len
    shape = (cfg.num_layers, batch_size, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "len": torch.zeros((), dtype=torch.int32, device=dev)}


def prefill_cache_rows(k, v, cache_size: int):
    """A one-shot prefill's K/V (B, L, Hkv, D) laid out in a cache of
    ``cache_size`` rows: zero-padded past L, or, for a ring (sliding-window)
    cache shorter than L, the last ``cache_size`` rows rolled so that
    position p sits at ring slot p % cache_size (decode writes the token at
    position p at slot p % S, so the layouts agree)."""
    L = k.shape[1]
    if cache_size > L:
        pad = (0, 0, 0, 0, 0, cache_size - L)
        return torch.nn.functional.pad(k, pad), \
            torch.nn.functional.pad(v, pad)
    if cache_size < L:
        shift = L % cache_size
        return (torch.roll(k[:, L - cache_size:], shift, dims=1),
                torch.roll(v[:, L - cache_size:], shift, dims=1))
    return k, v


def prefill_cache_size(cfg: ModelConfig, L: int, cache_size) -> int:
    """The cache rows a one-shot prefill of L tokens keeps: the asked size
    (default L), capped at the sliding window; full attention never
    trims below L."""
    cache_size = cache_size or L
    if cfg.sliding_window is not None:
        return min(cache_size, cfg.sliding_window)
    return max(cache_size, L)


def prefill_ffn(params, cfg: ModelConfig, batch, cache_size, ffn):
    tokens = batch["tokens"]
    B, L = tokens.shape
    cache_size = prefill_cache_size(cfg, L, cache_size)
    x = layers.embed(params["embed"], cfg, tokens).to(cfg.compute_dtype)
    positions = torch.arange(L, device=x.device)[None]
    shape = (cfg.num_layers, B, cache_size, cfg.num_kv_heads, cfg.head_dim)
    k_all = torch.empty(shape, dtype=x.dtype, device=x.device)
    v_all = torch.empty_like(k_all)
    for i in range(cfg.num_layers):
        lp = layer_params(params["blocks"], i)
        h, (k, v) = layers.attention_with_kv(
            lp["attn"], cfg, layers.apply_norm(lp["ln1"], cfg, x),
            positions=positions, causal=True, window=cfg.sliding_window)
        x = x + h
        x = x + ffn(lp, cfg, layers.apply_norm(lp["ln2"], cfg, x))
        k, v = prefill_cache_rows(k, v, cache_size)
        k_all[i].copy_(k)
        v_all[i].copy_(v)
    h = layers.apply_norm(params["ln_f"], cfg, x[:, -1])
    return logits_fn(params, cfg, h), {
        "k": k_all, "v": v_all,
        "len": torch.tensor(L, dtype=torch.int32, device=x.device)}


def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            cache_size=None):
    """One-shot prefill of ``batch["tokens"]`` (B, L): returns (logits at
    the last position (B, V), a new dense cache of ``cache_size`` rows
    (see ``prefill_cache_rows``) with the shared scalar ``len`` L)."""
    return prefill_ffn(params, cfg, batch, cache_size, dense_ffn)


def prefill_chunk_ffn(params, cfg: ModelConfig, batch, cache, chunk_len,
                      ffn):
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], cfg, tokens).to(cfg.compute_dtype)
    start = cache["len"]
    k_all, v_all = cache["k"], cache["v"]
    for i in range(cfg.num_layers):
        lp = layer_params(params["blocks"], i)
        h, _, _ = layers.attention_chunk(
            lp["attn"], cfg, layers.apply_norm(lp["ln1"], cfg, x), k_all[i],
            v_all[i], start, chunk_len, window=cfg.sliding_window)
        x = x + h
        x = x + ffn(lp, cfg, layers.apply_norm(lp["ln2"], cfg, x))
    h = layers.take_chunk_last(x, chunk_len)
    h = layers.apply_norm(params["ln_f"], cfg, h)
    return logits_fn(params, cfg, h), {
        "k": k_all, "v": v_all,
        "len": start + torch.as_tensor(chunk_len, dtype=torch.int32,
                                       device=x.device)}


def prefill_chunk(params, cfg: ModelConfig, batch, cache, *, chunk_len):
    """Chunked prefill against a dense cache: append a right-padded chunk
    of ``chunk_len`` <= T tokens (``batch["tokens"]`` (B, T)) at the
    offsets ``cache["len"]`` (scalar or (B,)), writing its K/V rows into
    the cache in place; every layer's attention is one launch of the dense
    chunk kernel.  Chaining chunks equals one-shot ``prefill``.  Returns
    (logits at each slot's last real token (B, V), cache with
    ``len + chunk_len``)."""
    return prefill_chunk_ffn(params, cfg, batch, cache, chunk_len,
                             dense_ffn)


def decode_step_ffn(params, cfg: ModelConfig, token, cache, live, ffn):
    lens = cache["len"]
    new_len = lens + 1
    x = layers.embed(params["embed"], cfg, token).to(cfg.compute_dtype)
    k_all, v_all = cache["k"], cache["v"]
    S, window = k_all.shape[2], cfg.sliding_window
    # a ring of exactly the window holds only visible keys: no mask needed
    eff_window = None if (window is None or S <= window) else window
    live = None if live is None else live.bool()
    for i in range(cfg.num_layers):
        lp = layer_params(params["blocks"], i)
        h, _, _ = layers.attention_decode(
            lp["attn"], cfg, layers.apply_norm(lp["ln1"], cfg, x), k_all[i],
            v_all[i], new_len, window=eff_window, live=live)
        x = x + h
        x = x + ffn(lp, cfg, layers.apply_norm(lp["ln2"], cfg, x))
    h = layers.apply_norm(params["ln_f"], cfg, x)
    return logits_fn(params, cfg, h), {
        "k": k_all, "v": v_all,
        "len": new_len if live is None else torch.where(live, new_len,
                                                        lens)}


def decode_step(params, cfg: ModelConfig, token, cache, *, live=None):
    """One new token per slot (``token`` (B,)) against a dense cache whose
    ``len`` (scalar or (B,)) counts tokens already cached: the token is
    written at ring slot ``len % S``, in place.  Where ``live`` (B,) is
    False a slot's cache and length are kept (the reference's
    ``merge_state`` commit) and its logits are garbage.  Returns (logits
    (B, V), cache with ``len + 1``)."""
    return decode_step_ffn(params, cfg, token, cache, live, dense_ffn)


def _chunk_paged_hidden(params, cfg: ModelConfig, batch, cache,
                        block_tables, chunk_len, block_size: int, ffn,
                        verify: bool):
    """The paged-native chunk body shared by chunked prefill and
    speculative verify: every layer writes the chunk's K/V rows into the
    pools in place and attends through the block tables.  Returns the
    last layer's hidden states (B, T, d) and the per-slot starts."""
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
            chunk_len, block_size=block_size, window=cfg.sliding_window,
            verify=verify)
        x = x + h
        x = x + ffn(lp, cfg, layers.apply_norm(lp["ln2"], cfg, x))
    return x, start


def prefill_chunk_paged_ffn(params, cfg: ModelConfig, batch, cache,
                            block_tables, chunk_len, block_size: int, ffn):
    x, start = _chunk_paged_hidden(params, cfg, batch, cache, block_tables,
                                   chunk_len, block_size, ffn, False)
    h = layers.take_chunk_last(x, chunk_len)
    h = layers.apply_norm(params["ln_f"], cfg, h[:, None])[:, 0]
    logits = logits_fn(params, cfg, h)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": start + chunk_len}


def verify_step_paged_ffn(params, cfg: ModelConfig, batch, cache,
                          block_tables, chunk_len, block_size: int, ffn):
    x, start = _chunk_paged_hidden(params, cfg, batch, cache, block_tables,
                                   chunk_len, block_size, ffn, True)
    h = layers.apply_norm(params["ln_f"], cfg, x)          # all T positions
    return logits_fn(params, cfg, h), {"k": cache["k"], "v": cache["v"],
                                       "len": start}


def prefill_chunk_paged(params, cfg: ModelConfig, batch, cache,
                        block_tables, *, chunk_len, block_size: int):
    """Paged-native chunked prefill: append a right-padded chunk of
    ``chunk_len`` <= T tokens (``batch["tokens"]`` (B, T)) to the page
    pools ``cache["k"]``/``cache["v"]`` through ``block_tables`` (B, nblk),
    starting at the per-slot offsets ``cache["len"]`` (B,).  The chunk's
    K/V rows are written into the pools in place.  Returns (logits at each
    slot's last real token (B, V), cache with ``len + chunk_len``)."""
    return prefill_chunk_paged_ffn(params, cfg, batch, cache, block_tables,
                                   chunk_len, block_size, dense_ffn)


def verify_step_paged(params, cfg: ModelConfig, batch, cache, block_tables,
                      *, chunk_len, block_size: int):
    """Speculative decoding's verify: score T = k+1 fed tokens
    ``[last emitted, d_1 .. d_k]`` (``batch["tokens"]`` (B, T)) against
    the page pools in one pass, with ``prefill_chunk_paged``'s body (the
    K/V rows written in place through the block tables) and ``chunk_len``
    a per-slot (B,) vector, T for the slots speculating and 0 for the
    rest (their rows go to the trash page).  The head runs over all T
    positions.  Returns (logits (B, T, V), cache with ``len`` unchanged:
    the engine commits each slot's length after acceptance, so the rows
    of rejected drafts lie past it and the next round overwrites them)."""
    return verify_step_paged_ffn(params, cfg, batch, cache, block_tables,
                                 chunk_len, block_size, dense_ffn)


def decode_step_paged(params, cfg: ModelConfig, token, cache, block_tables,
                      live, *, block_size: int):
    """Paged-native fused decode: ``token`` (B,) one new token per slot,
    ``cache["len"]`` (B,) tokens already cached per slot.  Attention reads
    K/V in place through ``block_tables`` and writes only each live slot's
    one new row (dead slots write to the trash page and keep their length).
    Returns (logits (B, V), cache with the live slots' ``len + 1``)."""
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
        x = x + layers.mlp(lp["mlp"], cfg,
                           layers.apply_norm(lp["ln2"], cfg, x))
    h = layers.apply_norm(params["ln_f"], cfg, x)
    logits = logits_fn(params, cfg, h)
    return logits, {"k": k_all, "v": v_all,
                    "len": torch.where(live, lens + 1, lens)}
