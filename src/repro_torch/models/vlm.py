"""PaliGemma-3B's language backbone: the gemma decoder (MQA with one kv
head, head dim 256, geglu, tied embeddings) behind a bidirectional image
prefix.

The SigLIP tower and projector are a stub, as in the reference:
requests carry precomputed patch embeddings ``batch["embeddings"]``
(B, prefix_len, d_model).  The parameters and the cache are the dense
decoder's (``transformer.py``); what differs is the input rows and the
mask: the ``prefix_len`` image rows come first and attend to each other
both ways, the text after them causally.

The FIRST chunk of a chunked prefill carries the embeddings and runs the
whole prefix with the first text bucket (prefix rows attend to later
prefix rows, so the prefix cannot span a chunk boundary): it writes
``chunk_len + prefix_len`` cache rows.  Later chunks are plain causal
appends.  After prefill every cached position is visible to a new token,
so decode is the dense decoder's, paged or not, sharded or not.  The
head-sharded chunk step (``prefill_chunk_paged_tp``) hands the first
chunk's image rows to every shard.  The training forward
``forward_hidden`` returns the hidden states of the whole prefix + text
sequence; the loss reads the text rows only (``training/train_step.py``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import layers, transformer
from .config import ModelConfig

init = transformer.init
logits_fn = transformer.logits_fn
init_cache = transformer.init_cache
decode_step = transformer.decode_step
decode_step_paged = transformer.decode_step_paged
decode_step_paged_tp = transformer.decode_step_paged_tp


def _concat_inputs(params, cfg: ModelConfig, batch):
    """The image rows, then the embedded text, in the compute dtype:
    (B, prefix_len + T, d)."""
    tok = transformer.embed_tokens(params, cfg, batch)
    img = torch.as_tensor(batch["embeddings"], device=tok.device).to(
        cfg.compute_dtype)
    return torch.cat([img, tok], dim=1)


def forward_hidden(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                   train: bool = False):
    """The final-norm hidden states (B, prefix_len + L, d) of the image
    rows and ``batch["tokens"]`` (B, L) under the prefix-LM mask, each
    layer checkpointed when ``train``; the aux loss is a zero."""
    return transformer.run_blocks(params, cfg,
                                  _concat_inputs(params, cfg, batch),
                                  train=train, prefix_len=cfg.prefix_len)


def _chunk_inputs(params, cfg: ModelConfig, batch, chunk_len):
    """A chunk's input rows, its prefix and the cache rows it writes: the
    first chunk (the one with ``embeddings``) carries the prefix."""
    if "embeddings" in batch:
        return (_concat_inputs(params, cfg, batch), cfg.prefix_len,
                chunk_len + cfg.prefix_len)
    return transformer.embed_tokens(params, cfg, batch), 0, chunk_len


def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            cache_size=None):
    """One-shot prefill of the image prefix and ``batch["tokens"]``.
    Callers budget ``cache_size`` in text tokens; the prefix rides along.
    Returns (logits at the last position, a dense cache whose ``len``
    counts the prefix)."""
    x = _concat_inputs(params, cfg, batch)
    return transformer.prefill_ffn(
        params, cfg, batch, cache_size + cfg.prefix_len if cache_size
        else None, transformer.dense_ffn, x=x, prefix_len=cfg.prefix_len)


def prefill_chunk(params, cfg: ModelConfig, batch, cache, *, chunk_len):
    """Chunked prefill against a dense cache (``transformer.prefill_chunk``);
    the first chunk writes ``chunk_len + prefix_len`` rows."""
    x, prefix, eff = _chunk_inputs(params, cfg, batch, chunk_len)
    return transformer.prefill_chunk_ffn(params, cfg, batch, cache, eff,
                                         transformer.dense_ffn, x=x,
                                         prefix_len=prefix)


def prefill_chunk_paged_tp(shards, cfg: ModelConfig, tokens, caches,
                           block_tables, chunk_len, *, block_size: int,
                           mesh=None, embeddings=None):
    """``transformer.prefill_chunk_paged_tp`` over ``shards``, its
    arguments one entry a shard on the shard's device.  The first chunk
    carries the image rows ``embeddings`` (one (B, prefix_len, d) entry a
    shard): every shard puts them ahead of its embedded tokens, attends
    over the whole prefix both ways and writes ``chunk_len + prefix_len``
    rows of its kv heads.  Later chunks are plain causal appends."""
    if embeddings is None:
        return transformer.prefill_chunk_paged_tp(
            shards, cfg, tokens, caches, block_tables, chunk_len,
            block_size=block_size, mesh=mesh)
    tok = layers.embed_tp(shards, cfg, tokens, mesh)
    x = [torch.cat([torch.as_tensor(e, device=t.device).to(
        cfg.compute_dtype), t], dim=1) for e, t in zip(embeddings, tok)]
    return transformer.prefill_chunk_paged_tp(
        shards, cfg, tokens, caches, block_tables,
        [cl + cfg.prefix_len for cl in chunk_len], block_size=block_size,
        mesh=mesh, x=x, prefix_len=cfg.prefix_len)


def prefill_chunk_paged(params, cfg: ModelConfig, batch, cache,
                        block_tables, *, chunk_len, block_size: int):
    """Paged-native chunked prefill (``transformer.prefill_chunk_paged``):
    every written row, prefix and text alike, lands in the page pools
    through the block tables; the first chunk writes ``chunk_len +
    prefix_len`` rows."""
    emb = batch.get("embeddings")
    logits, new_len = prefill_chunk_paged_tp(
        [transformer.Shard(params, cfg)], cfg, [batch["tokens"]], [cache],
        [block_tables], [chunk_len], block_size=block_size,
        embeddings=None if emb is None else [emb])
    return logits, {"k": cache["k"], "v": cache["v"], "len": new_len}
