"""Token samplers for the serving engine (the port of the reference
package's ``serving/sampler.py``).

Per-slot counter-based PRNG streams
-----------------------------------

A slot's sample stream must be a pure function of the request, never of
batch composition: the engine decodes at full static capacity, and slots
are admitted, evicted and parked in any order.  Each draw derives its key
by folding a counter chain into one base key:

    key = fold_in(fold_in(fold_in(fold_in(base, seed), sample_idx),
                          stream), offset)

* ``seed``: the request's seed (its rid unless the caller pinned one);
* ``sample_idx``: which of the request's n parallel samples this row is;
* ``stream``: which consumer draws (``STREAM_DECODE`` for the one token a
  step, ``STREAM_DRAFT`` for draft proposals, ``STREAM_VERIFY`` and
  ``STREAM_CORRECTION`` for speculative rejection sampling);
* ``offset``: the emitted length at which the draw happens.

The keys and draws are the reference's bit for bit: ``threefry2x32``
below is ``jax.random``'s threefry-2x32 hash (with
``jax_threefry_partitionable``, JAX's default), written in torch integer
ops.  A uint32 word is held in an ``int64`` tensor and masked to 32 bits
after every add and shift (``torch.uint32`` has few arithmetic kernels).
A key is an ``int64`` tensor whose last axis holds its two words.

* ``prng_key(seed)`` is ``jax.random.PRNGKey``: a seed below 2**32 becomes
  ``[0, seed]``, a wider one its high and low words.
* ``fold_in(key, d)`` hashes the counter pair ``[0, d]`` under ``key``.
* ``random_bits(key, shape)`` hashes the flat index of each element (its
  high and low words) under ``key`` and xors the two output words.
* ``uniform`` keeps the top 23 bits as a mantissa of ``[1, 2)``, subtracts
  1, adds ``minval`` and clamps below at it (the sampler's ranges,
  ``[0, 1)`` and ``[tiny, 1)``, scale by 1).
* ``gumbel`` is ``-log(-log(uniform(tiny, 1)))`` and ``categorical``
  ``argmax(gumbel + logits)``, the first index winning a tie.

The logarithms are taken in float64 and rounded to float32, so the card
and the CPU draw the same noise; XLA's float32 ``log`` on the CPU differs
from a correctly rounded one by a unit in the last place in about one
value in seven, so the Gumbel noise is the reference's to within two
units in the last place, and a token differs only where the reference's
top two perturbed scores lie that close.

Greedy sampling (``temperature <= 0``) draws no bits at all: ``argmax``,
whatever the batch, the park and resume history or the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Stream tags (the third fold_in in the counter chain).
STREAM_DECODE = 0      # the ordinary decode-loop sample
STREAM_DRAFT = 1       # draft-model proposals (speculative decoding)
STREAM_VERIFY = 2      # accept/reject uniforms in speculative_verify
STREAM_CORRECTION = 3  # residual/bonus draw in speculative_verify

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)
# rows of one stochastic draw at a time: keeps the int64 hash words of a
# wide vocabulary (minicpm-2b's 122,753 tokens) near 128 MB a tensor
_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => disabled


# ---------------------------------------------------------------------------
# threefry-2x32 in torch integer ops
# ---------------------------------------------------------------------------

def _words(x, device) -> torch.Tensor:
    """uint32 words (ints, a list or an array) as an int64 tensor."""
    return torch.as_tensor(np.asarray(x, dtype=np.int64) & _M,
                           device=device)


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    under the key ``(k0, k1)``; int64 tensors of uint32 words that
    broadcast together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = torch.broadcast_tensors(x0 + ks[0], x1 + ks[1])
    x0 = x0.bitwise_and(_M)      # fresh, full-shape words, then in place
    x1 = x1.bitwise_and(_M)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M)
            hi = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(
                hi.bitwise_and_(_M)).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_M)
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (2,) int64 words."""
    seed = int(seed)
    return _words([(seed >> 32) & _M, seed & _M], device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``key`` (..., 2), ``data``
    uint32 words broadcasting against ``key[..., 0]``."""
    data = _words(data, key.device) if not torch.is_tensor(data) else data
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def _counters(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _M


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit, partitionable) for each key
    of ``keys`` (..., 2): int64 words of shape ``keys.shape[:-1] +
    shape``."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    hi, lo = _counters(n, keys.device)
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(*lead, 1)
    k1 = keys[..., 1].reshape(*lead, 1)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return (b0 ^ b1).reshape(*lead, *shape)


def uniform_from_bits(bits: torch.Tensor,
                      minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(minval=minval, maxval=1)``'s float32 map of
    32-bit words (``minval`` is 0 or the smallest normal float32, so the
    scale ``1 - minval`` rounds to 1)."""
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats + minval, minval)


def uniform(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` on [0, 1) for each key."""
    return uniform_from_bits(random_bits(keys, shape))


def _neg_log(x: torch.Tensor) -> torch.Tensor:
    return -torch.log(x.double()).float()


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel(mode="low")``'s map of 32-bit words."""
    return _neg_log(_neg_log(uniform_from_bits(bits, _TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` of each row of ``logits`` (B, V) under its
    key of ``keys`` (B, 2): int64 (B,).  Rows go through in chunks, each
    row's draw its own."""
    B, V = logits.shape
    out = torch.empty((B,), dtype=torch.int64, device=logits.device)
    step = max(1, _CHUNK_ELEMS // max(1, V))
    for r0 in range(0, B, step):
        g = gumbel_from_bits(random_bits(keys[r0:r0 + step], (V,)))
        out[r0:r0 + step] = torch.argmax(g + logits[r0:r0 + step], dim=-1)
    return out


# ---------------------------------------------------------------------------
# the reference's samplers
# ---------------------------------------------------------------------------

def slot_keys(base_key, seeds, sample_ids, offsets,
              stream: int = STREAM_DECODE) -> torch.Tensor:
    """Per-row keys from the counter chain: (B,) words -> (B, 2) keys."""
    dev = base_key.device
    seeds = _words(seeds, dev)
    k = fold_in(base_key.expand(seeds.shape[0], 2), seeds)
    k = fold_in(k, _words(sample_ids, dev))
    k = fold_in(k, torch.full_like(seeds, int(stream) & _M))
    return fold_in(k, _words(offsets, dev))


def _filtered(logits, cfg: SamplerConfig):
    """Temperature-scaled, top_k-filtered logits (f32).  temperature > 0.
    Every entry tied with the k-th largest is kept, as the reference's
    ``scaled < cutoff`` test keeps it."""
    scaled = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        cutoff = torch.topk(scaled, cfg.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < cutoff,
                             torch.full_like(scaled, float("-inf")), scaled)
    return scaled


def _as_mask(m, device):
    if m is None:
        return None
    return torch.as_tensor(np.asarray(m) if not torch.is_tensor(m) else m,
                           device=device).bool()


def _apply_mask(out, live, occupancy, fill_token):
    mask = _as_mask(live, out.device)
    occ = _as_mask(occupancy, out.device)
    if occ is not None:
        mask = occ if mask is None else mask & occ
    if mask is not None:
        out = torch.where(mask, out, torch.full_like(out, fill_token))
    return out, mask


def sample(logits, key, cfg: SamplerConfig = SamplerConfig(), *,
           live=None, occupancy=None, fill_token: int = 0):
    """logits: (B, V) -> (B,) int32 under one shared key (2,): the
    reference's sync/batch sampler, which draws the whole (B, V) noise
    from that key.  Rows masked by ``live`` (finished slots) or
    ``occupancy`` (empty slots) emit ``fill_token``."""
    if cfg.temperature <= 0.0:
        out = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        B, V = logits.shape
        g = gumbel_from_bits(random_bits(key, (B, V)))
        out = torch.argmax(g + _filtered(logits, cfg), dim=-1).to(
            torch.int32)
    out, _ = _apply_mask(out, live, occupancy, fill_token)
    return out


def sample_per_slot(logits, base_key, seeds, sample_ids, offsets,
                    cfg: SamplerConfig = SamplerConfig(), *,
                    stream: int = STREAM_DECODE, live=None, occupancy=None,
                    fill_token: int = 0):
    """logits: (B, V) -> (B,) int32 with per-row counter-based keys.

    Row ``i`` draws with ``slot_keys(base_key, seeds[i], sample_ids[i],
    offsets[i], stream)``, a pure function of that request's identity and
    progress.  Rows masked by ``live`` (finished slots) or ``occupancy``
    (empty slots of the static-capacity batch) emit ``fill_token``.  Greedy
    never touches a key.  Stochastic draws only the rows the masks keep:
    the reference draws every row and masks after, which gives the same
    tokens (ROADMAP.md Queue 3)."""
    if cfg.temperature <= 0.0:
        # torch.argmax returns the first maximal index, as jnp.argmax does,
        # so ties (common in bf16 logits) resolve identically
        out = torch.argmax(logits, dim=-1).to(torch.int32)
        out, _ = _apply_mask(out, live, occupancy, fill_token)
        return out
    dev = logits.device
    B = logits.shape[0]
    out = torch.full((B,), fill_token, dtype=torch.int32, device=dev)
    _, mask = _apply_mask(out, live, occupancy, fill_token)
    rows = (torch.arange(B, device=dev) if mask is None
            else torch.nonzero(mask).flatten())
    if rows.numel() == 0:
        return out
    pick = rows.cpu().numpy()
    keys = slot_keys(base_key, np.asarray(seeds)[pick],
                     np.asarray(sample_ids)[pick],
                     np.asarray(offsets)[pick], stream)
    out[rows] = categorical(keys, _filtered(logits[rows], cfg)).to(
        torch.int32)
    return out


def _masked_probs(logits, cfg: SamplerConfig):
    """Softmax under the same temperature/top_k filter sampling uses
    (``jax.nn.softmax``'s order: exp of the max-shifted row over its
    sum)."""
    x = _filtered(logits, cfg)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def speculative_verify(target_logits, draft_logits, draft_tokens,
                       base_key, seeds, sample_ids, offsets,
                       cfg: SamplerConfig = SamplerConfig(), *,
                       live=None, occupancy=None, fill_token: int = 0):
    """Accept/reject k draft tokens against one fused target launch.

    ``target_logits`` (B, T, V) with T = k+1, ``draft_logits`` (B, k, V),
    ``draft_tokens`` (B, k), ``offsets`` (B,) the emitted length at the
    round's first verified position.  Returns ``(tokens, n_emit)``:
    ``tokens`` (B, T) int32, the emitted tokens left-aligned (accepted
    drafts, then the correction or bonus; the tail is ``fill_token``),
    ``n_emit`` (B,) int32 in ``[0, T]`` (0 only for masked rows).

    Greedy accepts the longest prefix where ``d_{j+1} == argmax(target[j])``
    and emits argmaxes, key-free.  Stochastic is the reference's exact
    leave-one-out rejection sampling: accept ``d`` when ``u * q(d) <=
    p(d)`` (``u`` from ``STREAM_VERIFY``); at the first reject draw from
    ``normalize(max(p - q, 0))``, and after k accepts the bonus from the
    target (``STREAM_CORRECTION``)."""
    B, T, V = target_logits.shape
    k = T - 1
    dev = target_logits.device
    draft_tokens = torch.as_tensor(draft_tokens, device=dev).to(torch.int64)
    pos = torch.arange(T, device=dev)[None, :]
    fill = torch.full((B, T), fill_token, dtype=torch.int64, device=dev)

    if cfg.temperature <= 0.0:
        targets = torch.argmax(target_logits, dim=-1)            # (B, T)
        match = draft_tokens == targets[:, :k]                   # (B, k)
        n_acc = torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1)
        out = targets
    else:
        p = _masked_probs(target_logits, cfg)                    # (B, T, V)
        q = _masked_probs(draft_logits, cfg)                     # (B, k, V)
        p_d = p[:, :k].gather(2, draft_tokens[..., None])[..., 0]
        q_d = q.gather(2, draft_tokens[..., None])[..., 0]
        vkeys = slot_keys(base_key, seeds, sample_ids, offsets,
                          STREAM_VERIFY)
        u = uniform(vkeys, (k,))                                 # (B, k)
        accept = u * q_d <= p_d
        n_acc = torch.cumprod(accept.to(torch.int32), dim=-1).sum(dim=-1)
        # the residual at the first rejected position; at the bonus
        # position (n_acc == k) the draft proposed nothing (q := 0 there)
        q_pad = torch.cat([q, torch.zeros((B, 1, V), dtype=q.dtype,
                                          device=dev)], dim=1)
        rows = torch.arange(B, device=dev)
        p_at = p[rows, n_acc]                                    # (B, V)
        q_at = q_pad[rows, n_acc]
        resid = torch.clamp_min(p_at - q_at, 0.0)
        rsum = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(rsum > 0, resid / torch.clamp_min(rsum, 1e-30),
                            p_at)
        ckeys = slot_keys(base_key, seeds, sample_ids, offsets,
                          STREAM_CORRECTION)
        corr = categorical(ckeys, torch.log(resid + 1e-30))
        acc = n_acc[:, None].to(torch.int64)
        out = torch.where(pos < acc, draft_tokens_padded(draft_tokens),
                          torch.where(pos == acc, corr[:, None], fill))

    n_emit = n_acc.to(torch.int64) + 1
    _, mask = _apply_mask(torch.ones((B,), dtype=torch.int32, device=dev),
                          live, occupancy, 0)
    if mask is not None:
        n_emit = torch.where(mask, n_emit, torch.zeros_like(n_emit))
        out = torch.where(mask[:, None], out, fill)
    # zero the tail past n_emit so garbage positions can't leak
    out = torch.where(pos < n_emit[:, None], out, fill)
    return out.to(torch.int32), n_emit.to(torch.int32)


def draft_tokens_padded(draft_tokens):
    """(B, k) -> (B, k+1): one pad column so the draft and correction
    selects share a (B, T) shape (position ``k`` is only ever the bonus)."""
    B = draft_tokens.shape[0]
    return torch.cat([draft_tokens, torch.zeros(
        (B, 1), dtype=draft_tokens.dtype, device=draft_tokens.device)],
        dim=1)
