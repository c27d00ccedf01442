"""Dense decoder-only transformer (llama/mistral/qwen/minicpm families):
the training forward and the paged-native serving entry points.

Parameters keep the reference's stacked layer axis: every leaf under
``params["blocks"]`` has a leading ``num_layers`` axis, and the reference's
``lax.scan`` over layers becomes a Python loop over that axis.  Caches hold
the serving arena's page pools ``(layers, pages, block_size, Hkv, D)``
(a tensor, or ``QuantPages`` for int8), which the steps update in place:
the returned cache holds the same pools.
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


def prefill_chunk_paged(params, cfg: ModelConfig, batch, cache,
                        block_tables, *, chunk_len, block_size: int):
    """Paged-native chunked prefill: append a right-padded chunk of
    ``chunk_len`` <= T tokens (``batch["tokens"]`` (B, T)) to the page
    pools ``cache["k"]``/``cache["v"]`` through ``block_tables`` (B, nblk),
    starting at the per-slot offsets ``cache["len"]`` (B,).  The chunk's
    K/V rows are written into the pools in place.  Returns (logits at each
    slot's last real token (B, V), cache with ``len + chunk_len``)."""
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
        x = x + layers.mlp(lp["mlp"], cfg,
                           layers.apply_norm(lp["ln2"], cfg, x))
    h = layers.take_chunk_last(x, chunk_len)
    h = layers.apply_norm(params["ln_f"], cfg, h[:, None])[:, 0]
    logits = logits_fn(params, cfg, h)
    return logits, {"k": k_all, "v": v_all, "len": start + chunk_len}


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
