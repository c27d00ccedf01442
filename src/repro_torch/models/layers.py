"""Shared neural-net layers of the dense decoder and the encoder-decoder.

Plain functions on tensors: params are nested dicts of tensors in the
reference package's layouts (weights ``(in, out)``, so ``linear`` is
``x @ w``), and every forward takes (params, cfg, ...).  Attention (dense,
paged, full and cross) goes through ``repro_torch.kernels.ops``, which runs
the CUDA kernels for tensors on the card and their plain versions on the
CPU.

Unlike the reference, caches are updated in place: ``paged_insert_rows``
writes the new rows into the pool it is given and ``write_rows`` into the
dense cache it is given, and each returns that same tensor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.quant import QuantPages, quantize

from .config import ModelConfig


# ---------------------------------------------------------------------------
# initializers / primitives
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1) * scale (default fan_in ** -0.5), drawn in f32 on the
    generator's device and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def rms_norm(x, w, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def layer_norm(x, w, b, eps: float):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def init_norm(cfg: ModelConfig, device, dim: Optional[int] = None):
    d = dim or cfg.d_model
    p = {"w": torch.ones((d,), dtype=cfg.weight_dtype, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros((d,), dtype=cfg.weight_dtype, device=device)
    return p


def apply_norm(p, cfg: ModelConfig, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.rms_eps)
    return rms_norm(x, p["w"], cfg.rms_eps)


def linear(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return y


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (..., L, H, D) rotated by ``positions`` (broadcastable to (..., L))."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs            # (..., L, half)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, d: int, device=None):
    """Whisper-style sinusoidal positional embedding table (length, d)."""
    return sinusoid_at(torch.arange(length, device=device), d)


def sinusoid_at(pos, d: int):
    """Sinusoidal embedding at per-slot positions, in f32: pos (B,) ->
    (B, d), so requests at different depths share one fused step."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=pos.device) / (half - 1))
    ang = pos.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, *,
                   cross: bool = False):
    """Self-attention projections, or with ``cross`` the separate q/k/v
    projections of a cross-attention (k and v read the encoder memory)."""
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.num_heads, \
        cfg.num_kv_heads
    dt, dev = cfg.weight_dtype, gen.device
    if cfg.fused_projections and not cross:
        p = {"wqkv": dense_init(gen, (d, (nq + 2 * nkv) * hd), dt),
             "wo": dense_init(gen, (nq * hd, d), dt)}
        if cfg.qkv_bias:
            p["bqkv"] = torch.zeros(((nq + 2 * nkv) * hd,), dtype=dt,
                                    device=dev)
        return p
    p = {"wq": dense_init(gen, (d, nq * hd), dt),
         "wk": dense_init(gen, (d, nkv * hd), dt),
         "wv": dense_init(gen, (d, nkv * hd), dt),
         "wo": dense_init(gen, (nq * hd, d), dt)}
    if cfg.qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((n * hd,), dtype=dt, device=dev)
    return p


def _split_qkv_flat(cfg: ModelConfig, qkv):
    hd, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = qkv[..., :nq * hd]
    k = qkv[..., nq * hd:(nq + nkv) * hd]
    v = qkv[..., (nq + nkv) * hd:]
    return q, k, v


def _project_qkv(p, cfg: ModelConfig, x, kv_x=None):
    """x (B, Lq, d) -> q (B, Lq, Hq, D); k and v (B, Lk, Hkv, D) from
    ``kv_x`` (B, Lk, d) when given (cross-attention), else from x."""
    B, Lq = x.shape[:2]
    kv_x = x if kv_x is None else kv_x
    Lk = kv_x.shape[1]
    if "wqkv" in p:
        q, k, v = _split_qkv_flat(cfg, linear(x, p["wqkv"], p.get("bqkv")))
    else:
        q = linear(x, p["wq"], p.get("bq"))
        k = linear(kv_x, p["wk"], p.get("bk"))
        v = linear(kv_x, p["wv"], p.get("bv"))
    q = q.reshape(B, Lq, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, Lk, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, Lk, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def attention_with_kv(p, cfg: ModelConfig, x, *, positions=None,
                      causal: bool = True, window: Optional[int] = None,
                      prefix_len: int = 0, kv_x=None, use_rope: bool = True):
    """The reference's ``layers.attention``: full (training, prefill,
    encoder or cross) attention through ``ops.flash_attention``,
    differentiable.  x (B, Lq, d) at ``positions`` (default 0..Lq-1) is
    rotated by rope unless ``use_rope`` is off; ``kv_x`` (B, Lk, d) makes
    it cross-attention (its keys are not rotated).  Returns (out
    (B, Lq, d), (k, v)), k and v as attended."""
    B, Lq, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    if use_rope:
        if positions is None:
            positions = torch.arange(Lq, device=x.device)[None]
        q = rope(q, positions, cfg.rope_theta)
        if kv_x is None:
            k = rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              prefix_len=prefix_len)
    out = out.reshape(B, Lq, cfg.num_heads * cfg.head_dim)
    return linear(out, p["wo"]), (k, v)


def attention(p, cfg: ModelConfig, x, *, causal: bool = True, kv_x=None):
    """Full attention without rope (the encoder-decoder's); ``kv_x``
    (B, Lk, d) makes it cross-attention.  Returns (B, Lq, d)."""
    return attention_with_kv(p, cfg, x, causal=causal, kv_x=kv_x,
                             use_rope=False)[0]


def write_rows(cache, rows, start, n):
    """Write ``rows`` (B, T, Hkv, D) into one layer's dense cache
    (B, S, Hkv, D), in place: row i of slot b lands at position
    ``start[b] + i`` for i < ``n[b]`` (``start``, ``n`` (B,) int).  The
    reference scatters with out-of-bounds indices for the other rows, which
    its scatter drops; here every row writes, without a host sync and with
    no two writes of different values to one place: a row past ``n[b]``
    repeats slot b's last written row at the same position, and a slot with
    ``n[b] == 0`` writes its row at ``start[b]`` back unchanged."""
    B, T = rows.shape[:2]
    S = cache.shape[1]
    dev = cache.device
    n = n.to(torch.long)
    j = torch.minimum(torch.arange(T, device=dev)[None],
                      (n - 1).clamp_min(0)[:, None])             # (B, T)
    dest = (start.to(torch.long)[:, None] + j).clamp(0, S - 1)
    bi = torch.arange(B, device=dev)[:, None].expand(B, T)
    src = rows[bi, j].to(cache.dtype)
    src = torch.where((n > 0)[:, None, None, None], src, cache[bi, dest])
    cache[bi, dest] = src
    return cache


def attention_decode(p, cfg: ModelConfig, x_t, k_cache, v_cache, cache_len,
                     *, window=None, use_rope: bool = True, live=None):
    """One-token decode against one layer's dense caches (B, S, Hkv, D).

    ``cache_len`` (scalar or (B,)) counts valid entries INCLUDING the token
    being written, at ring slot ``(cache_len - 1) % S``; attention sees the
    first ``min(cache_len, S)`` of them (the last ``window`` when set).
    The new K/V row is written into the caches in place.  Where ``live``
    (B,) is False a slot's cache is not written and its row attends to no
    key (zeros: its output is thrown away).  Returns (out (B, d), k_cache,
    v_cache)."""
    B = x_t.shape[0]
    dev = x_t.device
    q, k_t, v_t = _project_qkv(p, cfg, x_t[:, None])
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=dev).expand(B)
    if use_rope:
        pos = (cache_len - 1)[:, None]
        q = rope(q, pos, cfg.rope_theta)
        k_t = rope(k_t, pos, cfg.rope_theta)
    S = k_cache.shape[1]
    slot = torch.remainder(cache_len - 1, S)
    n = (torch.ones((B,), dtype=torch.int32, device=dev) if live is None
         else live.to(torch.int32))
    write_rows(k_cache, k_t, slot, n)
    write_rows(v_cache, v_t, slot, n)
    eff_len = torch.clamp(cache_len, max=S)
    if live is not None:
        eff_len = torch.where(live.bool(), eff_len, 0)
    out = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                               eff_len.to(torch.int32), window=window)
    out = out.reshape(B, cfg.num_heads * cfg.head_dim)
    return linear(out, p["wo"]), k_cache, v_cache


def attention_chunk(p, cfg: ModelConfig, x, k_cache, v_cache, cache_len,
                    chunk_len, *, window=None, prefix_len: int = 0,
                    use_rope: bool = True):
    """Chunked-prefill attention against one layer's dense caches
    (B, S, Hkv, D): write a right-padded T-token chunk (only the first
    ``chunk_len`` rows real) at positions ``cache_len + i``, in place, then
    attend over the cache through ``ops.chunk_attention``.  Returns (out
    (B, T, d), k_cache, v_cache); rows past ``chunk_len`` are zeros before
    the output projection (the caller discards them)."""
    B, T, _ = x.shape
    S = k_cache.shape[1]
    if window is not None and S > window:
        raise NotImplementedError(
            "chunked prefill does not support ring (sliding-window) cache "
            "layouts; the engine gates those to one-shot prefill")
    q, k_t, v_t = _project_qkv(p, cfg, x)
    dev = x.device
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=dev).expand(B)
    chunk_len = torch.as_tensor(chunk_len, dtype=torch.int32,
                                device=dev).expand(B)
    positions = cache_len[:, None] + torch.arange(T, device=dev)[None]
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k_t = rope(k_t, positions, cfg.rope_theta)
    # rows at or past the cache's end are dropped, as the reference's
    # out-of-bounds scatter drops them
    n = torch.clamp(torch.minimum(chunk_len, S - cache_len), 0, T)
    write_rows(k_cache, k_t, cache_len, n)
    write_rows(v_cache, v_t, cache_len, n)
    out = ops.chunk_attention(q.contiguous(), k_cache, v_cache,
                              cache_len.contiguous(), chunk_len.contiguous(),
                              prefix_len=prefix_len)
    out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
    return linear(out, p["wo"]), k_cache, v_cache


def cross_attention_decode(p, cfg: ModelConfig, x_t, memory):
    """Decode-time cross attention of x_t (B, d) against a fixed encoder
    memory (B, Lk, d).  Returns (B, d)."""
    return attention(p, cfg, x_t[:, None], causal=False, kv_x=memory)[:, 0]


def paged_insert_rows(pages, rows, block_tables, positions, valid, *,
                      block_size: int):
    """Scatter per-slot K/V rows straight into a page pool, in place.

    pages: one layer's physical pool (P, block_size, Hkv, D) whose LAST page
    is the arena's reserved trash block; rows: (B, T, Hkv, D) new cache
    rows; positions: (B, T) absolute token positions; valid: (B, T) bool.
    Invalid rows (dead slots, chunk padding) land in the trash page, so the
    scatter is branch-free.  A ``QuantPages`` pool quantizes the rows on
    insert: int8 values and their f32 scales land through the same flat
    index, so the pool only ever holds quantized blocks.  Returns ``pages``
    (the same object, updated)."""
    if isinstance(pages, QuantPages):
        qrows, srows = quantize(rows)
        paged_insert_rows(pages.values, qrows, block_tables, positions,
                          valid, block_size=block_size)
        paged_insert_rows(pages.scales, srows, block_tables, positions,
                          valid, block_size=block_size)
        return pages
    P = pages.shape[0]
    nblk = block_tables.shape[1]
    pos = positions.long().clamp(0, nblk * block_size - 1)
    blk = torch.gather(block_tables.long(), 1, pos // block_size)
    flat = blk * block_size + pos % block_size
    flat = torch.where(valid, flat, torch.full_like(flat,
                                                    (P - 1) * block_size))
    B, T = rows.shape[:2]
    pf = pages.view(P * block_size, *pages.shape[2:])
    pf[flat.reshape(-1)] = rows.reshape(B * T, *rows.shape[2:]).to(
        pages.dtype)
    return pages


def _no_paged_ring(window, total_tokens: int) -> None:
    if window is not None and window < total_tokens:
        raise NotImplementedError(
            "paged-native attention does not support ring (sliding-window) "
            "cache layouts; the engine gates those to the dense-view path")


def attention_decode_paged(p, cfg: ModelConfig, x_t, k_pages, v_pages,
                           block_tables, lens, live, *, block_size: int,
                           window=None, use_rope: bool = True):
    """One-token decode against one layer's paged KV.

    x_t: (B, d); pages (P, block_size, Hkv, D) read through
    ``block_tables`` (B, nblk); ``lens`` (B,) counts tokens already cached
    (the new token is written at position ``lens``).  Only each live slot's
    new K/V row is written, in place; attention reads K/V in place through
    ``ops.paged_decode_attention``.  Dead slots attend to no key (length 0)
    and their rows come out zero: unlike the reference, which attends them
    over their stale length, nothing reads K/V for an output that is thrown
    away.  Returns (out (B, d), k_pages, v_pages)."""
    B = x_t.shape[0]
    _no_paged_ring(window, block_tables.shape[1] * block_size)
    q, k_t, v_t = _project_qkv(p, cfg, x_t[:, None])
    lens = lens.to(torch.int32)
    if use_rope:
        q = rope(q, lens[:, None], cfg.rope_theta)
        k_t = rope(k_t, lens[:, None], cfg.rope_theta)
    live = live.bool()
    paged_insert_rows(k_pages, k_t, block_tables, lens[:, None],
                      live[:, None], block_size=block_size)
    paged_insert_rows(v_pages, v_t, block_tables, lens[:, None],
                      live[:, None], block_size=block_size)
    out = ops.paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                     block_tables,
                                     torch.where(live, lens + 1, 0))
    out = out.reshape(B, cfg.num_heads * cfg.head_dim)
    return linear(out, p["wo"]), k_pages, v_pages


def attention_chunk_paged(p, cfg: ModelConfig, x, k_pages, v_pages,
                          block_tables, cache_len, chunk_len, *,
                          block_size: int, window=None,
                          use_rope: bool = True, verify: bool = False):
    """Chunked-prefill attention against one layer's paged KV: write a
    right-padded T-token chunk (only the first ``chunk_len`` rows real) at
    positions ``cache_len + i`` into the pages, in place, then attend
    through the block table via ``ops.paged_chunk_attention``.

    ``verify=True`` is speculative decoding's verify contract: the same
    kernels, with ``chunk_len`` a per-slot (B,) vector whose 0 rows are the
    slots not speculating (their K/V rows go to the trash page and their
    outputs are zeros, which the verifier masks); it routes through
    ``ops.paged_verify_attention``, which holds the contract."""
    B, T, _ = x.shape
    _no_paged_ring(window, block_tables.shape[1] * block_size)
    q, k_t, v_t = _project_qkv(p, cfg, x)
    dev = x.device
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32, device=dev)
    if cache_len.ndim == 0:
        cache_len = cache_len.expand(B)
    chunk_len = torch.as_tensor(chunk_len, dtype=torch.int32, device=dev)
    if chunk_len.ndim == 0:
        chunk_len = chunk_len.expand(B)
    rows = torch.arange(T, device=dev)
    positions = cache_len[:, None] + rows[None]              # (B, T)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k_t = rope(k_t, positions, cfg.rope_theta)
    valid = rows[None] < chunk_len[:, None]
    paged_insert_rows(k_pages, k_t, block_tables, positions, valid,
                      block_size=block_size)
    paged_insert_rows(v_pages, v_t, block_tables, positions, valid,
                      block_size=block_size)
    attend = ops.paged_verify_attention if verify \
        else ops.paged_chunk_attention
    out = attend(q.contiguous(), k_pages, v_pages, block_tables, cache_len,
                 chunk_len)
    out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
    return linear(out, p["wo"]), k_pages, v_pages


def take_chunk_last(x, chunk_len):
    """x: (B, T, ...) right-padded chunk activations -> the row at
    ``chunk_len - 1`` per slot (the last real token's hidden state, whose
    logits seed sampling when the chunk completes a prompt)."""
    B, T = x.shape[:2]
    cl = torch.as_tensor(chunk_len, dtype=torch.long, device=x.device)
    if cl.ndim == 0:
        cl = cl.expand(B)
    idx = (cl - 1).clamp(0, T - 1)
    return x[torch.arange(B, device=x.device), idx]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.weight_dtype
    if cfg.activation in ("swiglu", "geglu"):
        if cfg.fused_projections:
            return {"w_gateup": dense_init(gen, (d, 2 * f), dt),
                    "w_down": dense_init(gen, (f, d), dt)}
        return {"w_gate": dense_init(gen, (d, f), dt),
                "w_up": dense_init(gen, (d, f), dt),
                "w_down": dense_init(gen, (f, d), dt)}
    return {"w_up": dense_init(gen, (d, f), dt),
            "w_down": dense_init(gen, (f, d), dt)}


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(p, cfg: ModelConfig, x):
    if "w_gateup" in p:
        gu = linear(x, p["w_gateup"])
        f = gu.shape[-1] // 2
        act = F.silu if cfg.activation == "swiglu" else _gelu
        h = act(gu[..., :f]) * gu[..., f:]
    elif cfg.activation == "swiglu":
        h = F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"])
    elif cfg.activation == "geglu":
        h = _gelu(linear(x, p["w_gate"])) * linear(x, p["w_up"])
    else:  # gelu_mlp
        h = _gelu(linear(x, p["w_up"]))
    return linear(h, p["w_down"])


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ModelConfig):
    p = {"embedding": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                 cfg.weight_dtype, scale=1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  cfg.weight_dtype)
    return p


def embed(p, cfg: ModelConfig, tokens):
    return p["embedding"][tokens.long()]


def unembed(p, cfg: ModelConfig, h):
    if cfg.tie_embeddings:
        return h @ p["embedding"].T
    return h @ p["unembed"]
