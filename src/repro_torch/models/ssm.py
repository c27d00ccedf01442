"""Mamba-2 (SSD, state-space duality) model, attention-free (mamba2-2.7b):
the serving entry points.

Block = in_proj -> causal depthwise conv (silu) -> SSD chunked scan (the
``ssd_scan`` CUDA kernel on the card) -> gated RMSNorm -> out_proj.
Decode is O(1) per token: a (k-1)-deep conv tail plus the (H, P, N) SSD
state per slot.

Parameters keep the reference's stacked layer axis, and its ``lax.scan``
over layers becomes a loop over that axis.  The cache is
``{"conv": (layers, B, k-1, ch), "ssd": (layers, B, H, P, N) f32, "len"}``.
Unlike the reference's functional carry, ``prefill_chunk`` and
``decode_step`` update ``cache["conv"]`` and ``cache["ssd"]`` IN PLACE,
layer by layer, and return the same tensors: the carry would materialise a
second full state stack (21.5 GB at 128 slots of mamba2-2.7b).  The
one-shot ``prefill`` (``mamba_block`` over the whole prompt, one SSD scan
launch a layer) builds a new cache.  ``forward_hidden`` (training) is
ROADMAP.md Queue 1 item 12.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

from . import layers
from .config import ModelConfig
from .transformer import layer_params, stack_layers


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig):
    d, di = cfg.d_model, cfg.d_inner
    H, G, N = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_state
    k = cfg.ssm_conv_kernel
    ch = conv_channels(cfg)
    dt_, dev = cfg.weight_dtype, gen.device
    return {
        "ln": layers.init_norm(cfg, dev),
        "in_proj": layers.dense_init(gen, (d, 2 * di + 2 * G * N + H), dt_),
        "conv_w": layers.dense_init(gen, (k, ch), dt_, scale=k ** -0.5),
        "conv_b": torch.zeros((ch,), dtype=dt_, device=dev),
        # float32 whatever the weight dtype, as in the reference
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "gate_ln": {"w": torch.ones((di,), dtype=dt_, device=dev)},
        "out_proj": layers.dense_init(gen, (di, d), dt_),
    }


def init(seed: int, cfg: ModelConfig, device=None):
    """Random weights from ``seed`` on ``device`` (the card unless
    ``"cpu"``), in the reference's tree layout.  The draws differ from the
    reference's ``jax.random`` ones; tests carry reference weights over
    with ``repro_torch.bridge.params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return {"embed": layers.init_embedding(gen, cfg),
            "blocks": stack_layers([init_mamba_block(gen, cfg)
                                    for _ in range(cfg.num_layers)]),
            "ln_f": layers.init_norm(cfg, dev)}


def logits_fn(params, cfg: ModelConfig, hidden):
    return layers.unembed(params["embed"], cfg, hidden)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """Per-slot state only: nothing grows with ``max_len``, so the serving
    arena (which probes this on the ``meta`` device) pages nothing."""
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    k, ch = cfg.ssm_conv_kernel, conv_channels(cfg)
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    Lyr = cfg.num_layers
    return {
        "conv": torch.zeros((Lyr, batch_size, k - 1, ch), dtype=dtype,
                            device=dev),
        "ssd": torch.zeros((Lyr, batch_size, H, P, N), dtype=torch.float32,
                           device=dev),
        "len": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, G, N = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * G * N]
    dt = zxbcdt[..., di + di + 2 * G * N:]
    assert dt.shape[-1] == cfg.ssm_nheads
    return z, xBC, dt


def _split_xbc(cfg: ModelConfig, xBC_conv):
    """(..., ch) -> x (..., H, P), B and C (..., G, N): views."""
    di, G, N = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    lead = xBC_conv.shape[:-1]
    xs = xBC_conv[..., :di].reshape(*lead, cfg.ssm_nheads, cfg.ssm_headdim)
    Bm = xBC_conv[..., di:di + G * N].reshape(*lead, G, N)
    Cm = xBC_conv[..., di + G * N:].reshape(*lead, G, N)
    return xs, Bm, Cm


def _gated_out(p, cfg: ModelConfig, y, z):
    """Gated RMSNorm, then out_proj."""
    y = layers.rms_norm(y * F.silu(z.float()).to(y.dtype),
                        p["gate_ln"]["w"], cfg.rms_eps)
    return layers.linear(y, p["out_proj"])


def _conv_step(p, conv_state, u_t):
    """conv_state: (B, k-1, ch); u_t: (B, ch) -> (y_t, new_state), in f32
    as the reference's einsum."""
    window = torch.cat([conv_state, u_t[:, None]], dim=1)       # (B, k, ch)
    y = (window.float() * p["conv_w"].float()[None]).sum(dim=1)
    y = F.silu(y + p["conv_b"].float()).to(u_t.dtype)
    return y, window[:, 1:]


def _causal_conv(p, u):
    """u: (B, L, ch) depthwise causal conv with kernel (k, ch) from zeros:
    the sum of k shifted products, then silu in f32, as the reference."""
    k = p["conv_w"].shape[0]
    L = u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    y = sum(pad[:, i:i + L] * p["conv_w"][i][None, None] for i in range(k))
    return F.silu((y + p["conv_b"][None, None]).float()).to(u.dtype)


def mamba_block(p, cfg: ModelConfig, x, *, initial_state=None,
                return_state: bool = False):
    """x: (B, L, d) -> x + the block's output (B, L, d), through one SSD
    scan over the whole sequence (the ``ssd_scan`` kernel on the card).
    With ``return_state`` also the state a decode continues from: the raw
    pre-conv tail (B, k-1, ch) of the last k-1 positions (zeros in front
    when L < k-1) and the SSD state (B, H, P, N) f32."""
    B, L, _ = x.shape
    k = cfg.ssm_conv_kernel
    xn = layers.apply_norm(p["ln"], cfg, x)
    z, xBC, dt = _split_proj(cfg, layers.linear(xn, p["in_proj"]))
    xs, Bm, Cm = _split_xbc(cfg, _causal_conv(p, xBC))
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    y, state = ops.ssd_scan(xs, dt, A, Bm, Cm, p["D"], chunk=cfg.ssm_chunk,
                            initial_state=initial_state)
    out = x + _gated_out(p, cfg, y.reshape(B, L, cfg.d_inner), z)
    if not return_state:
        return out
    tail = xBC[:, -(k - 1):] if L >= k - 1 else F.pad(
        xBC, (0, 0, k - 1 - L, 0))
    return out, (tail, state)


def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            cache_size=None):
    """One-shot prefill of ``batch["tokens"]`` (B, L) (``cache_size`` is
    accepted for the common signature: the state does not grow).  Returns
    (logits at the last position (B, V), a new cache with each layer's conv
    tail and SSD state and the shared scalar ``len`` L)."""
    tokens = batch["tokens"]
    B, L = tokens.shape
    x = layers.embed(params["embed"], cfg, tokens).to(cfg.compute_dtype)
    cache = init_cache(cfg, B, L, dtype=x.dtype, device=x.device)
    for i in range(cfg.num_layers):
        x, (tail, state) = mamba_block(layer_params(params["blocks"], i),
                                       cfg, x, return_state=True)
        cache["conv"][i].copy_(tail)
        cache["ssd"][i].copy_(state)
    h = layers.apply_norm(params["ln_f"], cfg, x[:, -1])
    cache["len"] = torch.tensor(L, dtype=torch.int32, device=x.device)
    return logits_fn(params, cfg, h), cache


def mamba_block_chunk(p, cfg: ModelConfig, x, conv_state, ssd_state,
                      chunk_len):
    """Chunked-prefill mamba block: advance one layer's recurrent state by
    a right-padded chunk of ``chunk_len`` <= T tokens.

    x: (B, T, d); conv_state: (B, k-1, ch) raw pre-conv tail; ssd_state:
    (B, H, P, N) f32.  Padding rows past ``chunk_len`` are identity steps
    (dt = 0), and the new conv tail ends at the last real token, so the
    returned state equals running exactly ``chunk_len`` steps.  Returns
    (out (B, T, d), conv_tail, ssd_state); the inputs are not modified."""
    B, T, _ = x.shape
    k = cfg.ssm_conv_kernel
    xn = layers.apply_norm(p["ln"], cfg, x)
    z, xBC, dt = _split_proj(cfg, layers.linear(xn, p["in_proj"]))
    cl = torch.as_tensor(chunk_len, dtype=torch.long, device=x.device)
    if cl.ndim == 0:
        cl = cl.expand(B)
    # causal conv primed with the carried (k-1)-deep raw tail: the sum of
    # k shifted products, as the reference writes it
    padded = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    y = sum(padded[:, i:i + T] * p["conv_w"][i][None, None]
            for i in range(k))
    xBC_conv = F.silu((y + p["conv_b"][None, None]).float()).to(xBC.dtype)
    xs, Bm, Cm = _split_xbc(cfg, xBC_conv)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    valid = torch.arange(T, device=x.device)[None] < cl[:, None]  # (B, T)
    dt = torch.where(valid[..., None], dt, 0.0)
    A = -torch.exp(p["A_log"])
    y, state = ops.ssd_scan(xs, dt, A, Bm, Cm, p["D"], chunk=cfg.ssm_chunk,
                            initial_state=ssd_state)
    out = x + _gated_out(p, cfg, y.reshape(B, T, cfg.d_inner), z)
    # new raw tail: the k-1 positions ending at the last real token (the
    # conv_state prefix covers chunks shorter than the kernel)
    idx = cl[:, None] + torch.arange(k - 1, device=x.device)[None]
    tail = torch.gather(padded, 1,
                        idx[..., None].expand(-1, -1, padded.shape[-1]))
    return out, tail, state


def mamba_block_decode(p, cfg: ModelConfig, x_t, conv_state, ssd_state,
                       live=None):
    """One decode token per slot.  x_t: (B, d); conv_state: (B, k-1, ch)
    and ssd_state: (B, H, P, N) f32, both updated IN PLACE.  Slots where
    ``live`` (B,) is False keep both states unchanged (the reference's
    ``merge_state`` commit): their conv tail is not written, and their SSD
    step gets dt = 0, an identity step, as the chunk's padding rows do.
    Returns the block's output (B, d)."""
    B = x_t.shape[0]
    xn = layers.apply_norm(p["ln"], cfg, x_t[:, None])[:, 0]
    z, xBC, dt = _split_proj(cfg, layers.linear(xn, p["in_proj"]))
    xBC_conv, new_conv = _conv_step(p, conv_state, xBC)
    if live is None:
        conv_state.copy_(new_conv)
    else:
        conv_state.copy_(torch.where(live[:, None, None], new_conv,
                                     conv_state))
    xs, Bm, Cm = _split_xbc(cfg, xBC_conv)
    dt = F.softplus(dt.float() + p["dt_bias"][None])
    if live is not None:
        dt = torch.where(live[:, None], dt, 0.0)
    A = -torch.exp(p["A_log"])
    y, _ = ops.ssd_decode_step(ssd_state, xs, dt, A, Bm, Cm, p["D"])
    return x_t + _gated_out(p, cfg, y.reshape(B, cfg.d_inner), z)


def prefill_chunk(params, cfg: ModelConfig, batch, cache, *, chunk_len):
    """Chunked prefill: advance the conv/SSD state by one right-padded
    chunk ``batch["tokens"]`` (B, T) of ``chunk_len`` real tokens per slot
    (see ``mamba_block_chunk``), writing each layer's new state into
    ``cache`` in place.  Returns (logits at each slot's last real token
    (B, V), cache with ``len + chunk_len``)."""
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], cfg, tokens).to(cfg.compute_dtype)
    conv_all, ssd_all = cache["conv"], cache["ssd"]
    for i in range(cfg.num_layers):
        x, tail, state = mamba_block_chunk(
            layer_params(params["blocks"], i), cfg, x, conv_all[i],
            ssd_all[i], chunk_len)
        conv_all[i].copy_(tail)
        ssd_all[i].copy_(state)
    h = layers.take_chunk_last(x, chunk_len)
    h = layers.apply_norm(params["ln_f"], cfg, h[:, None])[:, 0]
    return logits_fn(params, cfg, h), {
        "conv": conv_all, "ssd": ssd_all,
        "len": cache["len"] + torch.as_tensor(chunk_len,
                                              device=x.device)}


def decode_step(params, cfg: ModelConfig, token, cache, *, live=None):
    """Fused decode: ``token`` (B,) one new token per slot.  The state is
    updated in place; slots where ``live`` (B,) is False keep theirs and
    their length.  Returns (logits (B, V), cache with the live slots'
    ``len + 1``)."""
    x = layers.embed(params["embed"], cfg, token).to(cfg.compute_dtype)
    conv_all, ssd_all = cache["conv"], cache["ssd"]
    for i in range(cfg.num_layers):
        x = mamba_block_decode(layer_params(params["blocks"], i), cfg, x,
                               conv_all[i], ssd_all[i], live)
    h = layers.apply_norm(params["ln_f"], cfg, x[:, None])[:, 0]
    lens = cache["len"]
    new_len = lens + 1 if live is None else torch.where(live, lens + 1, lens)
    return logits_fn(params, cfg, h), {"conv": conv_all, "ssd": ssd_all,
                                       "len": new_len}
