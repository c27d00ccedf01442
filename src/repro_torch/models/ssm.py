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
one-shot ``prefill`` (the mixer over the whole prompt, one SSD scan
launch a layer) builds a new cache.  Each serving step is its ``*_tp``
function over one shard, the whole tree; ``tp`` SSD head shards run the
head-sharded step (``launch/steps.py`` ``paged_decode_builder``).
``forward_hidden`` is the training forward: ``mamba_block`` a layer, each checkpointed when
training, the scan's gradient through ``ops.ssd_scan``'s recompute.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

from . import layers
from .config import ModelConfig
from .transformer import Shard, layer_params, stack_layers, unbind_layers


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


def forward_hidden(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                   train: bool = False):
    """The final-norm hidden states (B, L, d) of ``batch["tokens"]``
    (B, L), every layer one ``mamba_block`` (one SSD scan over the whole
    sequence) under a non-reentrant checkpoint when ``train``; the aux
    loss is a zero."""
    h = layers.embed(params["embed"], cfg, batch["tokens"]).to(
        cfg.compute_dtype)
    for lp in unbind_layers(params["blocks"], cfg.num_layers):
        h = (checkpoint(mamba_block, lp, cfg, h, use_reentrant=False)
             if train else mamba_block(lp, cfg, h))
    h = layers.apply_norm(params["ln_f"], cfg, h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def logits_fn(params, cfg: ModelConfig, hidden):
    return layers.unembed(params["embed"], cfg, hidden)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """Per-slot state only: nothing grows with ``max_len``, so the serving
    arena (which probes this on the ``meta`` device) pages nothing."""
    return state_cache(cfg, batch_size, cfg.ssm_nheads,
                       dtype or cfg.compute_dtype, resolve_device(device))


def state_cache(cfg: ModelConfig, batch_size: int, H: int, dtype,
                device) -> Dict[str, Any]:
    """Zero state of ``H`` SSD heads (the model's, or a head shard's): the
    conv tail over those heads' x channels and B and C whole, and their
    f32 SSD state."""
    k, P, N = cfg.ssm_conv_kernel, cfg.ssm_headdim, cfg.ssm_state
    ch = H * P + 2 * cfg.ssm_ngroups * N
    Lyr = cfg.num_layers
    return {
        "conv": torch.zeros((Lyr, batch_size, k - 1, ch), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((Lyr, batch_size, H, P, N), dtype=torch.float32,
                           device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def _heads(p) -> int:
    """The SSD heads a layer's parameters hold: the model's, or a head
    shard's (``A_log`` is one entry a head)."""
    return p["A_log"].shape[-1]


def _split_proj(cfg: ModelConfig, zxbcdt, H: int):
    """in_proj's output over ``H`` heads, its columns ``z | x | B | C |
    dt`` (a head shard's: its heads' z, x and dt, B and C whole) -> z,
    xBC and dt: views."""
    di, G, N = H * cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * G * N]
    dt = zxbcdt[..., di + di + 2 * G * N:]
    assert dt.shape[-1] == H
    return z, xBC, dt


def _split_xbc(cfg: ModelConfig, xBC_conv, H: int):
    """(..., ch) -> x (..., H, P), B and C (..., G, N): views."""
    di, G, N = H * cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    lead = xBC_conv.shape[:-1]
    xs = xBC_conv[..., :di].reshape(*lead, H, cfg.ssm_headdim)
    Bm = xBC_conv[..., di:di + G * N].reshape(*lead, G, N)
    Cm = xBC_conv[..., di + G * N:].reshape(*lead, G, N)
    return xs, Bm, Cm


def _gated_out(p, cfg: ModelConfig, y, z):
    """Gated RMSNorm, then out_proj."""
    y = layers.rms_norm(y * F.silu(z.float()).to(y.dtype),
                        p["gate_ln"]["w"], cfg.rms_eps)
    return layers.linear(y, p["out_proj"])


def _gated_out_tp(lps, cfg: ModelConfig, ys, zs, mesh):
    """``_gated_out`` over head shards (layer params ``lps``, the
    mixer's ``ys`` and ``zs``, one a shard): the RMSNorm runs over the
    whole ``d_inner``, so each shard's f32 sum of squares is reduced
    before the scale (a shard normalizing its own heads would be wrong),
    then each shard's ``out_proj`` rows give a partial product that the
    mesh reduces.  One shard is ``_gated_out`` itself, op for op."""
    if len(lps) == 1:
        return [_gated_out(lps[0], cfg, ys[0], zs[0])]
    g = [y * F.silu(z.float()).to(y.dtype) for y, z in zip(ys, zs)]
    sq = mesh.all_reduce([(gs.float() * gs.float()).sum(-1, keepdim=True)
                          for gs in g])
    out = []
    for lp, gs, ss in zip(lps, g, sq):
        yn = gs.float() * torch.rsqrt(ss / cfg.d_inner + cfg.rms_eps)
        yn = (yn * lp["gate_ln"]["w"].float()).to(gs.dtype)
        out.append(layers.linear(yn, lp["out_proj"]))
    return mesh.all_reduce(out)


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


def _mixer_full(p, cfg: ModelConfig, x, initial_state=None):
    """A layer's mixer over a whole sequence, up to the gated norm: (y
    (B, L, H*P), z, the raw pre-conv tail, the SSD state) over the heads
    ``p`` holds (see ``mamba_block``)."""
    B, L, _ = x.shape
    k = cfg.ssm_conv_kernel
    xn = layers.apply_norm(p["ln"], cfg, x)
    H = _heads(p)
    z, xBC, dt = _split_proj(cfg, layers.linear(xn, p["in_proj"]), H)
    xs, Bm, Cm = _split_xbc(cfg, _causal_conv(p, xBC), H)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    y, state = ops.ssd_scan(xs, dt, A, Bm, Cm, p["D"], chunk=cfg.ssm_chunk,
                            initial_state=initial_state)
    tail = xBC[:, -(k - 1):] if L >= k - 1 else F.pad(
        xBC, (0, 0, k - 1 - L, 0))
    return y.reshape(B, L, H * cfg.ssm_headdim), z, tail, state


def mamba_block(p, cfg: ModelConfig, x, *, initial_state=None,
                return_state: bool = False):
    """x: (B, L, d) -> x + the block's output (B, L, d), through one SSD
    scan over the whole sequence (the ``ssd_scan`` kernel on the card).
    With ``return_state`` also the state a decode continues from: the raw
    pre-conv tail (B, k-1, ch) of the last k-1 positions (zeros in front
    when L < k-1) and the SSD state (B, H, P, N) f32."""
    y, z, tail, state = _mixer_full(p, cfg, x, initial_state)
    out = x + _gated_out(p, cfg, y, z)
    return (out, (tail, state)) if return_state else out


def prefill_tp(shards, cfg: ModelConfig, tokens, cache_size=None, *,
               mesh=None):
    """One-shot prefill over SSD head shards (``transformer.Shard``s;
    ``tokens`` one copy a shard, on its device): each shard's mixer runs
    its heads over the whole prompt (one SSD scan a layer a shard), B and
    C whole on every shard; the gated norm's sum of squares and
    ``out_proj``'s partial products are reduced by ``mesh``
    (``_gated_out_tp``).  ``cache_size`` is taken for the common
    signature: the state does not grow.  One shard without a mesh is the
    unsharded ``prefill``, op for op.  Returns (logits at the last
    position (B, V) on the first shard's device, one new cache a shard:
    its heads' conv channels (B and C whole) and SSD state, as
    ``steps.state_split`` splits them, with ``len`` L)."""
    x = layers.embed_tp(shards, cfg, tokens, mesh)
    B, L = x[0].shape[:2]
    caches = [state_cache(cfg, B, _heads(layer_params(s.params["blocks"], 0)),
                          xs.dtype, xs.device) for s, xs in zip(shards, x)]
    for i in range(cfg.num_layers):
        lps = [layer_params(s.params["blocks"], i) for s in shards]
        mixed = [_mixer_full(lp, cfg, xs) for lp, xs in zip(lps, x)]
        for (_, _, tail, state), c in zip(mixed, caches):
            c["conv"][i].copy_(tail)
            c["ssd"][i].copy_(state)
        out = _gated_out_tp(lps, cfg, [m[0] for m in mixed],
                            [m[1] for m in mixed], mesh)
        x = [xs + o for xs, o in zip(x, out)]
    h = [layers.apply_norm(s.params["ln_f"], cfg, xs[:, -1])
         for s, xs in zip(shards, x)]
    for c in caches:
        c["len"].fill_(L)
    return layers.unembed_tp(shards, cfg, h, mesh), caches


def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            cache_size=None):
    """One-shot prefill of ``batch["tokens"]`` (B, L) (``cache_size`` is
    accepted for the common signature: the state does not grow).  Returns
    (logits at the last position (B, V), a new cache with each layer's conv
    tail and SSD state and the shared scalar ``len`` L)."""
    logits, (cache,) = prefill_tp([Shard(params, cfg)], cfg,
                                  [batch["tokens"]], cache_size)
    return logits, cache


def _mixer_chunk(p, cfg: ModelConfig, x, conv_state, ssd_state,
                 chunk_len):
    """A layer's mixer over a right-padded chunk of ``chunk_len`` <= T
    tokens, up to the gated norm, over the heads ``p`` holds: advances the
    layer's recurrent state by the chunk.  x: (B, T, d); conv_state: (B,
    k-1, ch) raw pre-conv tail; ssd_state: (B, H, P, N) f32.  Padding rows
    past ``chunk_len`` are identity steps (dt = 0), and the new conv tail
    ends at the last real token, so the returned state equals running
    exactly ``chunk_len`` steps.  Returns (y (B, T, H*P), z, conv_tail,
    ssd_state); the inputs are not modified."""
    B, T, _ = x.shape
    k = cfg.ssm_conv_kernel
    H = _heads(p)
    xn = layers.apply_norm(p["ln"], cfg, x)
    z, xBC, dt = _split_proj(cfg, layers.linear(xn, p["in_proj"]), H)
    cl = torch.as_tensor(chunk_len, dtype=torch.long, device=x.device)
    if cl.ndim == 0:
        cl = cl.expand(B)
    # causal conv primed with the carried (k-1)-deep raw tail: the sum of
    # k shifted products, as the reference writes it
    padded = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    y = sum(padded[:, i:i + T] * p["conv_w"][i][None, None]
            for i in range(k))
    xBC_conv = F.silu((y + p["conv_b"][None, None]).float()).to(xBC.dtype)
    xs, Bm, Cm = _split_xbc(cfg, xBC_conv, H)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    valid = torch.arange(T, device=x.device)[None] < cl[:, None]  # (B, T)
    dt = torch.where(valid[..., None], dt, 0.0)
    A = -torch.exp(p["A_log"])
    y, state = ops.ssd_scan(xs, dt, A, Bm, Cm, p["D"], chunk=cfg.ssm_chunk,
                            initial_state=ssd_state)
    # new raw tail: the k-1 positions ending at the last real token (the
    # conv_state prefix covers chunks shorter than the kernel)
    idx = cl[:, None] + torch.arange(k - 1, device=x.device)[None]
    tail = torch.gather(padded, 1,
                        idx[..., None].expand(-1, -1, padded.shape[-1]))
    return y.reshape(B, T, H * cfg.ssm_headdim), z, tail, state


def mamba_block_chunk(p, cfg: ModelConfig, x, conv_state, ssd_state,
                      chunk_len):
    """Chunked-prefill mamba block: x + the block's output (B, T, d) over
    a right-padded chunk (``_mixer_chunk``), and the new conv tail and SSD
    state.  Returns (out, conv_tail, ssd_state)."""
    y, z, tail, state = _mixer_chunk(p, cfg, x, conv_state, ssd_state,
                                     chunk_len)
    return x + _gated_out(p, cfg, y, z), tail, state


def _mixer_decode(p, cfg: ModelConfig, x_t, conv_state, ssd_state, live):
    """A layer's mixer for one decode token per slot, up to the gated
    norm, over the heads ``p`` holds.  x_t: (B, d); conv_state: (B, k-1,
    ch) and ssd_state: (B, H, P, N) f32, both updated IN PLACE.  Slots
    where ``live`` (B,) is False keep both states unchanged (the
    reference's ``merge_state`` commit): their conv tail is not written,
    and their SSD step gets dt = 0, an identity step, as the chunk's
    padding rows do.  Returns (y (B, H*P), z)."""
    B = x_t.shape[0]
    H = _heads(p)
    xn = layers.apply_norm(p["ln"], cfg, x_t[:, None])[:, 0]
    z, xBC, dt = _split_proj(cfg, layers.linear(xn, p["in_proj"]), H)
    xBC_conv, new_conv = _conv_step(p, conv_state, xBC)
    if live is None:
        conv_state.copy_(new_conv)
    else:
        conv_state.copy_(torch.where(live[:, None, None], new_conv,
                                     conv_state))
    xs, Bm, Cm = _split_xbc(cfg, xBC_conv, H)
    dt = F.softplus(dt.float() + p["dt_bias"][None])
    if live is not None:
        dt = torch.where(live[:, None], dt, 0.0)
    A = -torch.exp(p["A_log"])
    y, _ = ops.ssd_decode_step(ssd_state, xs, dt, A, Bm, Cm, p["D"])
    return y.reshape(B, H * cfg.ssm_headdim), z


def prefill_chunk_paged_tp(shards, cfg: ModelConfig, tokens, caches,
                           block_tables, chunk_len, *, block_size: int = 0,
                           mesh=None):
    """``prefill_chunk`` over SSD head shards (``transformer.Shard``s),
    its arguments one entry a shard on the shard's device: ``caches``
    each shard's ``{"conv", "ssd", "len"}`` state (its heads' SSD state,
    its heads' conv channels and B and C whole), updated in place layer by
    layer.  Each shard's mixer runs on its heads; the gated norm's sum of
    squares and ``out_proj``'s partial products are reduced by ``mesh``
    (``_gated_out_tp``).  ``block_tables`` and ``block_size`` are taken
    for the paged steps' signature: an SSM pages nothing.  One shard
    without a mesh is the unsharded ``prefill_chunk``, op for op.
    Returns (logits at each slot's last real token (B, V) on the first
    shard's device, ``len + chunk_len``)."""
    x = layers.embed_tp(shards, cfg, tokens, mesh)
    for i in range(cfg.num_layers):
        lps = [layer_params(s.params["blocks"], i) for s in shards]
        mixed = [_mixer_chunk(lp, cfg, xs, c["conv"][i], c["ssd"][i], cl)
                 for lp, xs, c, cl in zip(lps, x, caches, chunk_len)]
        for (_, _, tail, state), c in zip(mixed, caches):
            c["conv"][i].copy_(tail)
            c["ssd"][i].copy_(state)
        out = _gated_out_tp(lps, cfg, [m[0] for m in mixed],
                            [m[1] for m in mixed], mesh)
        x = [xs + o for xs, o in zip(x, out)]
    h = [layers.apply_norm(s.params["ln_f"], cfg,
                           layers.take_chunk_last(xs, cl)[:, None])[:, 0]
         for s, xs, cl in zip(shards, x, chunk_len)]
    lens = caches[0]["len"]
    return (layers.unembed_tp(shards, cfg, h, mesh),
            lens + torch.as_tensor(chunk_len[0], device=lens.device))


def prefill_chunk(params, cfg: ModelConfig, batch, cache, *, chunk_len):
    """Chunked prefill: advance the conv/SSD state by one right-padded
    chunk ``batch["tokens"]`` (B, T) of ``chunk_len`` real tokens per slot
    (see ``_mixer_chunk``), writing each layer's new state into
    ``cache`` in place.  Returns (logits at each slot's last real token
    (B, V), cache with ``len + chunk_len``)."""
    logits, new_len = prefill_chunk_paged_tp(
        [Shard(params, cfg)], cfg, [batch["tokens"]], [cache], [None],
        [chunk_len])
    return logits, {"conv": cache["conv"], "ssd": cache["ssd"],
                    "len": new_len}


def decode_step_paged_tp(shards, cfg: ModelConfig, token, caches,
                         block_tables, live, *, block_size: int = 0,
                         mesh=None):
    """``decode_step`` over SSD head shards, its arguments one entry a
    shard as in ``prefill_chunk_paged_tp``.  Returns (logits (B, V) on
    the first shard's device, the live slots' ``len + 1``)."""
    live = [None if lv is None else lv.bool() for lv in live]
    x = layers.embed_tp(shards, cfg, token, mesh)
    for i in range(cfg.num_layers):
        lps = [layer_params(s.params["blocks"], i) for s in shards]
        mixed = [_mixer_decode(lp, cfg, xs, c["conv"][i], c["ssd"][i], lv)
                 for lp, xs, c, lv in zip(lps, x, caches, live)]
        out = _gated_out_tp(lps, cfg, [m[0] for m in mixed],
                            [m[1] for m in mixed], mesh)
        x = [xs + o for xs, o in zip(x, out)]
    h = [layers.apply_norm(s.params["ln_f"], cfg, xs[:, None])[:, 0]
         for s, xs in zip(shards, x)]
    lens = caches[0]["len"]
    new_len = (lens + 1 if live[0] is None
               else torch.where(live[0], lens + 1, lens))
    return layers.unembed_tp(shards, cfg, h, mesh), new_len


def decode_step(params, cfg: ModelConfig, token, cache, *, live=None):
    """Fused decode: ``token`` (B,) one new token per slot.  The state is
    updated in place; slots where ``live`` (B,) is False keep theirs and
    their length.  Returns (logits (B, V), cache with the live slots'
    ``len + 1``)."""
    logits, new_len = decode_step_paged_tp(
        [Shard(params, cfg)], cfg, [token], [cache], [None], [live])
    return logits, {"conv": cache["conv"], "ssd": cache["ssd"],
                    "len": new_len}
