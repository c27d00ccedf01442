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
``decode_step_ffn``, ``prefill_chunk_paged_ffn``, ``verify_step_paged_ffn`` and
``decode_step_paged_ffn`` take the block's FFN as ``ffn(layer params,
cfg, x)``.

Every serving step runs one layer loop over a list of ``Shard``s (the
``*_tp`` functions): one shard, the whole tree, for an unsharded model;
``tp`` head shards whose partial attention and FFN outputs a mesh
reduces for the head-sharded step (``launch/steps.py``
``paged_decode_builder``): the paged-native decode, chunk and verify
steps, and the dense ``decode_step_tp``, ``prefill_chunk_tp`` and
one-shot ``prefill_tp`` (the dense-view oracle and ring layouts).

``verify_step_paged`` is speculative decoding's one fused verify pass:
``prefill_chunk_paged``'s body with the head over every chunk position.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

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
    (B, L), and the auxiliary loss (a zero: dense models have none)."""
    return run_blocks(params, cfg, embed_tokens(params, cfg, batch),
                      train=train)


def run_blocks(params, cfg: ModelConfig, h, *, train: bool,
               prefix_len: int = 0):
    """The stacked blocks over the input rows h (B, L, d), causal but
    bidirectional over the first ``prefix_len`` rows, then the final
    norm; returns (hidden, a zero aux loss).  With ``train`` each layer
    runs under a non-reentrant checkpoint (the reference's
    ``jax.checkpoint`` of the scan body): its activations are recomputed
    in the backward, flash attention's forward kernel included."""
    kw = dict(positions=torch.arange(h.shape[1], device=h.device)[None],
              window=cfg.sliding_window, prefix_len=prefix_len)
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


def embed_tokens(params, cfg: ModelConfig, batch):
    """The embedded ``batch["tokens"]`` in the compute dtype."""
    return layers.embed(params["embed"], cfg, batch["tokens"]).to(
        cfg.compute_dtype)


def prefill_tp(shards: List["Shard"], cfg: ModelConfig, tokens, cache_size,
               *, mesh=None, ffn=dense_ffn, x=None, prefix_len: int = 0):
    """One-shot prefill over ``shards`` (``tokens``, and ``x`` when
    given, one entry a shard on its device): every layer's attention over
    each shard's heads is a partial output the mesh reduces, as in the
    paged steps.  Returns (logits at the last position (B, V) on the
    first shard's device, one new dense cache a shard holding its kv
    heads' rows, laid out by ``prefill_cache_rows``, with ``len`` L)."""
    if x is None:
        x = layers.embed_tp(shards, cfg, tokens, mesh)
    B, L = x[0].shape[:2]
    cache_size = prefill_cache_size(cfg, L, cache_size)
    positions = [torch.arange(L, device=xs.device)[None] for xs in x]
    k_all = [torch.empty((cfg.num_layers, B, cache_size, s.cfg.num_kv_heads,
                          cfg.head_dim), dtype=xs.dtype, device=xs.device)
             for s, xs in zip(shards, x)]
    v_all = [torch.empty_like(k) for k in k_all]

    def attend(i, j, p, scfg, xn):
        h, (k, v) = layers.attention_with_kv(
            p, scfg, xn, positions=positions[j], causal=True,
            window=cfg.sliding_window, prefix_len=prefix_len)
        k, v = prefill_cache_rows(k, v, cache_size)
        k_all[j][i].copy_(k)
        v_all[j][i].copy_(v)
        return h

    for i in range(cfg.num_layers):
        x = _block_paged(shards, cfg, i, x, attend, mesh, ffn)
    h = [layers.apply_norm(s.params["ln_f"], cfg, xs[:, -1])
         for s, xs in zip(shards, x)]
    return layers.unembed_tp(shards, cfg, h, mesh), [
        {"k": k, "v": v, "len": torch.tensor(L, dtype=torch.int32,
                                              device=k.device)}
        for k, v in zip(k_all, v_all)]


def prefill_ffn(params, cfg: ModelConfig, batch, cache_size, ffn, *,
                x=None, prefix_len: int = 0):
    """The one-shot prefill body; ``x`` (B, L, d), when given, replaces
    the embedded tokens (the VLM's image prefix and text), and its first
    ``prefix_len`` rows attend to each other both ways."""
    logits, (cache,) = prefill_tp(
        [Shard(params, cfg)], cfg, [batch.get("tokens")], cache_size,
        ffn=ffn, x=None if x is None else [x], prefix_len=prefix_len)
    return logits, cache


def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            cache_size=None):
    """One-shot prefill of ``batch["tokens"]`` (B, L): returns (logits at
    the last position (B, V), a new dense cache of ``cache_size`` rows
    (see ``prefill_cache_rows``) with the shared scalar ``len`` L)."""
    return prefill_ffn(params, cfg, batch, cache_size, dense_ffn)


def prefill_chunk_tp(shards: List["Shard"], cfg: ModelConfig, tokens,
                     caches, chunk_len, *, mesh=None, ffn=dense_ffn, x=None,
                     prefix_len: int = 0):
    """The dense-cache chunk over ``shards`` (``tokens``, ``caches``,
    ``chunk_len`` and ``x`` one entry a shard): each shard writes the
    chunk's K/V rows of its heads into its dense cache (its gathered
    dense view) in place and attends over it.  Returns (logits at each
    slot's last real token (B, V) on the first shard's device, ``len +
    chunk_len``)."""
    if x is None:
        x = layers.embed_tp(shards, cfg, tokens, mesh)
    start = [c["len"] for c in caches]

    def attend(i, j, p, scfg, xn):
        return layers.attention_chunk(
            p, scfg, xn, caches[j]["k"][i], caches[j]["v"][i], start[j],
            chunk_len[j], window=cfg.sliding_window,
            prefix_len=prefix_len)[0]

    for i in range(cfg.num_layers):
        x = _block_paged(shards, cfg, i, x, attend, mesh, ffn)
    h = [layers.apply_norm(s.params["ln_f"], cfg,
                           layers.take_chunk_last(xs, cl))
         for s, xs, cl in zip(shards, x, chunk_len)]
    return layers.unembed_tp(shards, cfg, h, mesh), start[0] + \
        torch.as_tensor(chunk_len[0], dtype=torch.int32, device=x[0].device)


def prefill_chunk_ffn(params, cfg: ModelConfig, batch, cache, chunk_len,
                      ffn, *, x=None, prefix_len: int = 0):
    """The dense-cache chunk body; ``x`` and ``prefix_len`` as in
    ``prefill_ffn``, with ``chunk_len`` counting the rows of ``x``."""
    logits, new_len = prefill_chunk_tp(
        [Shard(params, cfg)], cfg, [batch.get("tokens")], [cache],
        [chunk_len], ffn=ffn, x=None if x is None else [x],
        prefix_len=prefix_len)
    return logits, {"k": cache["k"], "v": cache["v"], "len": new_len}


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


def decode_step_tp(shards: List["Shard"], cfg: ModelConfig, token, caches,
                   live, *, mesh=None, ffn=dense_ffn):
    """``decode_step`` over ``shards``: ``token``, ``caches`` (each
    shard's dense cache of its kv heads, a gathered dense view or a
    window ring, with its copy of ``len``) and ``live`` (None or (B,))
    one entry a shard.  Each shard writes its heads' new row in place.
    Returns (logits (B, V) on the first shard's device, the new lengths,
    kept where a slot is not live)."""
    lens = [c["len"] for c in caches]
    new_len = [n + 1 for n in lens]
    x = layers.embed_tp(shards, cfg, token, mesh)
    S, window = caches[0]["k"].shape[2], cfg.sliding_window
    # a ring of exactly the window holds only visible keys: no mask needed
    eff_window = None if (window is None or S <= window) else window
    live = [None if lv is None else lv.bool() for lv in live]

    def attend(i, j, p, scfg, xn):
        return layers.attention_decode(
            p, scfg, xn, caches[j]["k"][i], caches[j]["v"][i], new_len[j],
            window=eff_window, live=live[j])[0]

    for i in range(cfg.num_layers):
        x = _block_paged(shards, cfg, i, x, attend, mesh, ffn)
    h = [layers.apply_norm(s.params["ln_f"], cfg, xs)
         for s, xs in zip(shards, x)]
    return layers.unembed_tp(shards, cfg, h, mesh), (
        new_len[0] if live[0] is None
        else torch.where(live[0], new_len[0], lens[0]))


def decode_step_ffn(params, cfg: ModelConfig, token, cache, live, ffn):
    logits, new_len = decode_step_tp([Shard(params, cfg)], cfg, [token],
                                     [cache], [live], ffn=ffn)
    return logits, {"k": cache["k"], "v": cache["v"], "len": new_len}


def decode_step(params, cfg: ModelConfig, token, cache, *, live=None):
    """One new token per slot (``token`` (B,)) against a dense cache whose
    ``len`` (scalar or (B,)) counts tokens already cached: the token is
    written at ring slot ``len % S``, in place.  Where ``live`` (B,) is
    False a slot's cache and length are kept (the reference's
    ``merge_state`` commit) and its logits are garbage.  Returns (logits
    (B, V), cache with ``len + 1``)."""
    return decode_step_ffn(params, cfg, token, cache, live, dense_ffn)


@dataclasses.dataclass
class Shard:
    """One model shard of a paged step: its parameter tree, its config
    and what it holds.  A head-sharded attention model's shard holds its
    kv heads with their GQA groups of query heads, its FFN columns and rows
    where split (``mlp_split``: the MLP's, or each expert's), its
    vocabulary rows [lo, hi) where split (``vocab``; None: the whole
    table) and the norms whole, and its config counts its heads.  An SSM
    shard holds its SSD heads' columns and rows (its config is the whole
    model's: the steps read a shard's head count from its parameters).  An
    unsharded model is one shard of its whole tree."""
    params: Dict[str, Any]
    cfg: ModelConfig
    vocab: Optional[Tuple[int, int]] = None
    mlp_split: bool = False


def shard_sum(mesh, partials):
    """The shards' partial results summed by ``mesh``; without a mesh (one
    shard) the one result as it is."""
    return list(partials) if mesh is None else mesh.all_reduce(partials)


def _block_paged(shards: List[Shard], cfg: ModelConfig, i: int, x, attend,
                 mesh, ffn):
    """Layer ``i`` on every shard: each shard's attention over its heads
    (``attend(i, shard index, layer params, shard config, normed x)``)
    and its FFN part are partial sums that the mesh reduces; a whole FFN
    runs on each shard alone.  ``x``: the residual rows, whole on each
    shard.  One shard without a mesh is the unsharded layer, op for op."""
    lps = [layer_params(s.params["blocks"], i) for s in shards]
    h = shard_sum(mesh, [attend(i, j, lp["attn"], s.cfg,
                                layers.apply_norm(lp["ln1"], cfg, xs))
                         for j, (s, lp, xs) in enumerate(zip(shards, lps,
                                                             x))])
    x = [xs + hs for xs, hs in zip(x, h)]
    m = [ffn(lp, cfg, layers.apply_norm(lp["ln2"], cfg, xs))
         for lp, xs in zip(lps, x)]
    if shards[0].mlp_split:
        m = shard_sum(mesh, m)
    return [xs + ms for xs, ms in zip(x, m)]


def _chunk_paged_hidden(shards: List[Shard], cfg: ModelConfig, tokens,
                        caches, block_tables, chunk_len, *, block_size: int,
                        mesh=None, ffn=dense_ffn, verify: bool = False,
                        x=None, prefix_len: int = 0):
    """The paged-native chunk body shared by chunked prefill and
    speculative verify, over ``shards`` (``tokens``, ``caches``,
    ``block_tables`` and ``chunk_len`` one entry a shard, on its device):
    every layer writes the chunk's K/V rows of each shard's heads into its
    pools in place and attends through the block tables.  ``x`` (one
    entry a shard), when given, replaces the embedded tokens (the VLM's
    image prefix and text), and its first ``prefix_len`` rows attend to
    each other both ways.  Returns the last layer's hidden states (B, T,
    d) and the per-slot starts, one entry a shard."""
    if x is None:
        x = layers.embed_tp(shards, cfg, tokens, mesh)
    start = [torch.as_tensor(c["len"], dtype=torch.int32,
                             device=xs.device).reshape(-1)
             for c, xs in zip(caches, x)]

    def attend(i, j, p, scfg, xn):
        return layers.attention_chunk_paged(
            p, scfg, xn, caches[j]["k"][i], caches[j]["v"][i],
            block_tables[j], start[j], chunk_len[j], block_size=block_size,
            window=cfg.sliding_window, prefix_len=prefix_len,
            verify=verify)[0]

    for i in range(cfg.num_layers):
        x = _block_paged(shards, cfg, i, x, attend, mesh, ffn)
    return x, start


def prefill_chunk_paged_tp(shards: List[Shard], cfg: ModelConfig, tokens,
                           caches, block_tables, chunk_len, *,
                           block_size: int, mesh=None, ffn=dense_ffn,
                           x=None, prefix_len: int = 0):
    """``prefill_chunk_paged`` over ``shards``, its arguments one entry a
    shard as in ``_chunk_paged_hidden``: each shard writes the chunk's
    K/V rows of its heads into its pools.  Returns (logits at each slot's
    last real token (B, V) on the first shard's device, ``len +
    chunk_len``)."""
    x, start = _chunk_paged_hidden(
        shards, cfg, tokens, caches, block_tables, chunk_len,
        block_size=block_size, mesh=mesh, ffn=ffn, x=x,
        prefix_len=prefix_len)
    h = [layers.apply_norm(s.params["ln_f"], cfg,
                           layers.take_chunk_last(xs, cl)[:, None])[:, 0]
         for s, xs, cl in zip(shards, x, chunk_len)]
    return layers.unembed_tp(shards, cfg, h, mesh), start[0] + chunk_len[0]


def prefill_chunk_paged_ffn(params, cfg: ModelConfig, batch, cache,
                            block_tables, chunk_len, block_size: int, ffn,
                            *, x=None, prefix_len: int = 0):
    logits, new_len = prefill_chunk_paged_tp(
        [Shard(params, cfg)], cfg, [batch.get("tokens")], [cache],
        [block_tables], [chunk_len], block_size=block_size, ffn=ffn,
        x=None if x is None else [x], prefix_len=prefix_len)
    return logits, {"k": cache["k"], "v": cache["v"], "len": new_len}


def verify_step_paged_tp(shards: List[Shard], cfg: ModelConfig, tokens,
                         caches, block_tables, chunk_len, *,
                         block_size: int, mesh=None, ffn=dense_ffn):
    """``verify_step_paged`` over ``shards``, its arguments one entry a
    shard as in ``_chunk_paged_hidden`` (``chunk_len`` (B,) on each):
    each shard writes the fed rows of its heads into its pools.  The head
    runs over all T positions.  Returns (logits (B, T, V) on the first
    shard's device, ``len`` unchanged)."""
    x, start = _chunk_paged_hidden(
        shards, cfg, tokens, caches, block_tables, chunk_len,
        block_size=block_size, mesh=mesh, ffn=ffn, verify=True)
    h = [layers.apply_norm(s.params["ln_f"], cfg, xs)      # all T positions
         for s, xs in zip(shards, x)]
    return layers.unembed_tp(shards, cfg, h, mesh), start[0]


def verify_step_paged_ffn(params, cfg: ModelConfig, batch, cache,
                          block_tables, chunk_len, block_size: int, ffn):
    logits, start = verify_step_paged_tp(
        [Shard(params, cfg)], cfg, [batch["tokens"]], [cache],
        [block_tables], [chunk_len], block_size=block_size, ffn=ffn)
    return logits, {"k": cache["k"], "v": cache["v"], "len": start}


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


def decode_step_paged_tp(shards: List[Shard], cfg: ModelConfig, token,
                         caches, block_tables, live, *, block_size: int,
                         mesh=None, ffn=dense_ffn):
    """``decode_step_paged`` over ``shards``: ``token``, ``caches`` (each
    shard's pools and its copy of ``len``), ``block_tables`` and ``live``
    hold one entry a shard, on the shard's device.  Returns (logits (B,
    V) on the first shard's device, the live slots' ``len + 1``)."""
    lens = [c["len"].to(torch.int32) for c in caches]
    live = [lv.bool() for lv in live]
    x = layers.embed_tp(shards, cfg, token, mesh)

    def attend(i, j, p, scfg, xn):
        return layers.attention_decode_paged(
            p, scfg, xn, caches[j]["k"][i], caches[j]["v"][i],
            block_tables[j], lens[j], live[j], block_size=block_size,
            window=cfg.sliding_window)[0]

    for i in range(cfg.num_layers):
        x = _block_paged(shards, cfg, i, x, attend, mesh, ffn)
    h = [layers.apply_norm(s.params["ln_f"], cfg, xs)
         for s, xs in zip(shards, x)]
    return (layers.unembed_tp(shards, cfg, h, mesh),
            torch.where(live[0], lens[0] + 1, lens[0]))


def decode_step_paged_ffn(params, cfg: ModelConfig, token, cache,
                          block_tables, live, block_size: int, ffn):
    logits, new_len = decode_step_paged_tp(
        [Shard(params, cfg)], cfg, [token], [cache], [block_tables], [live],
        block_size=block_size, ffn=ffn)
    return logits, {"k": cache["k"], "v": cache["v"], "len": new_len}


def decode_step_paged(params, cfg: ModelConfig, token, cache, block_tables,
                      live, *, block_size: int):
    """Paged-native fused decode: ``token`` (B,) one new token per slot,
    ``cache["len"]`` (B,) tokens already cached per slot.  Attention reads
    K/V in place through ``block_tables`` and writes only each live slot's
    one new row (dead slots write to the trash page and keep their length).
    Returns (logits (B, V), cache with the live slots' ``len + 1``)."""
    return decode_step_paged_ffn(params, cfg, token, cache, block_tables,
                                 live, block_size, dense_ffn)
