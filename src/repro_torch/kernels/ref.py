"""Plain PyTorch versions of the kernels: flash attention (forward and
backward), dense and paged attention, the Mamba-2 SSD scan and the grouped
(per-expert) GEMM, plus the SSD decode step, which has no kernel.

Fully materialized math with the reference package's semantics
(``kernels/ref.py``, ``kernels/flash_attention.py`` and the paged helpers
of ``kernels/decode_attention.py``).
The CPU path runs these; on the card they are only the yardstick the CUDA
kernels are held against, never the main path (except
``ssd_decode_step_ref``, which runs on both).

Attention shapes: q (B, Hq, D) for decode, (B, T, Hq, D) for a chunk;
caches (B, S, Hkv, D) with Hq % Hkv == 0 (GQA: query head h reads kv head
h // (Hq // Hkv)).  Rows that see no key produce zeros.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .quant import QuantPages, dequantize

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def per_slot(x, B: int, device) -> torch.Tensor:
    """A scalar or (B,) int -> contiguous (B,) int32 tensor on ``device``."""
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return x.expand(B).contiguous() if x.ndim == 0 else x.contiguous()


def _flash_mask(qpos, kpos, *, causal: bool, window: Optional[int],
                prefix_len: int, kv_len: int):
    """(Lq, Lk) bool: key kpos is visible to the row at qpos (the flash
    kernels' element mask, see ``flash_attention_ref``)."""
    qpos, kpos = qpos[:, None], kpos[None]
    ok = kpos < kv_len
    if causal:
        vis = kpos <= qpos
        if window is not None:
            vis = vis & (kpos > qpos - window)
        if prefix_len:
            vis = vis | (kpos < prefix_len)
        ok = ok & vis
    return ok


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, prefix_len: int = 0,
                        q_offset: int = 0, kv_len: Optional[int] = None,
                        softmax_scale=None):
    """Full attention with the mask of the reference's flash kernel, and
    its log-sum-exp.  q (B, Lq, Hq, D), k and v (B, Lk, Hkv, D).

    Row i sits at position ``q_offset + i``; a key at kpos is visible iff
    kpos < kv_len and, when ``causal``, kpos <= qpos (and kpos > qpos -
    window when a window is set) or kpos < prefix_len.  A row that sees
    nothing gets out = 0 and lse = -NEG_INF.  Returns (out (B, Lq, Hq, D)
    in q's dtype, lse (B, Lq, Hq) f32)."""
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    kv_len = Lk if kv_len is None else kv_len
    ok = _flash_mask(q_offset + torch.arange(Lq, device=q.device),
                     torch.arange(Lk, device=q.device), causal=causal,
                     window=window, prefix_len=prefix_len, kv_len=kv_len)
    qg = q.reshape(B, Lq, Hkv, G, D).float()
    s = torch.einsum("blhgd,bshd->bhgls", qg, k.float()) * scale
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * ok
    l = p.sum(dim=-1)
    out = torch.einsum("bhgls,bshd->blhgd", p, v.float())
    out = out / l.clamp_min(1e-37).permute(0, 3, 1, 2)[..., None]
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-37)), -NEG_INF)
    return (out.reshape(B, Lq, Hq, D).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(B, Lq, Hq))


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: Optional[int] = None, prefix_len: int = 0,
                            q_offset: int = 0, kv_len: Optional[int] = None,
                            softmax_scale=None, q_chunk: int = 512,
                            k_chunk: int = 512):
    """The recomputing flash backward of ``flash_attention_ref``: (dq, dk,
    dv) in q's, k's and v's dtypes from the forward's residuals ``out``
    (B, Lq, Hq, D) and ``lse`` (B, Lq, Hq) f32 and the output gradient
    ``dout``.  Chunk by chunk (``q_chunk`` rows against ``k_chunk`` keys)
    it recomputes P = exp(S - lse) and takes dS = P (dP - delta) scale,
    with delta = rowsum(dout * out) in f32, never the whole attention
    matrix.  As in the reference's oracle, dS and P are rounded to the
    inputs' dtype before their products, which sum in f32.  Chunks are
    ragged slices, so no padded row needs an lse; a row that sees no key
    (lse = -NEG_INF) gets P = 0."""
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    kv_len = Lk if kv_len is None else kv_len
    dev, f32 = q.device, torch.float32
    delta = (dout.float() * out.float()).sum(-1)              # (B, Lq, Hq)
    dq = torch.zeros(B, Lq, Hkv, G, D, dtype=f32, device=dev)
    dk = torch.zeros(B, Lk, Hkv, D, dtype=f32, device=dev)
    dv = torch.zeros(B, Lk, Hkv, D, dtype=f32, device=dev)
    for q0 in range(0, Lq, q_chunk):
        q1 = min(q0 + q_chunk, Lq)
        n = q1 - q0
        qt = q[:, q0:q1].reshape(B, n, Hkv, G, D).float()
        dot = dout[:, q0:q1].reshape(B, n, Hkv, G, D).float()
        lt = lse[:, q0:q1].reshape(B, n, Hkv, G).permute(0, 2, 3, 1)
        dlt = delta[:, q0:q1].reshape(B, n, Hkv, G).permute(0, 2, 3, 1)
        qpos = q_offset + torch.arange(q0, q1, device=dev)
        for k0 in range(0, Lk, k_chunk):
            k1 = min(k0 + k_chunk, Lk)
            kt, vt = k[:, k0:k1].float(), v[:, k0:k1].float()
            ok = _flash_mask(qpos, torch.arange(k0, k1, device=dev),
                             causal=causal, window=window,
                             prefix_len=prefix_len, kv_len=kv_len)
            s = torch.einsum("blhgd,bshd->bhgls", qt, kt) * scale
            s = torch.where(ok, s, NEG_INF)
            p = torch.exp(s - lt[..., None])                 # (B, h, g, l, s)
            dp = torch.einsum("blhgd,bshd->bhgls", dot, vt)
            ds = (p * (dp - dlt[..., None]) * scale).to(k.dtype).float()
            p = p.to(dout.dtype).float()
            dq[:, q0:q1] += torch.einsum("bhgls,bshd->blhgd", ds, kt)
            dk[:, k0:k1] += torch.einsum("bhgls,blhgd->bshd", ds, qt)
            dv[:, k0:k1] += torch.einsum("bhgls,blhgd->bshd", p, dot)
    return (dq.reshape(B, Lq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q, k_cache, v_cache, cache_len, *,
                         window: Optional[int] = None, softmax_scale=None):
    """Single-token decode attention against a (B, S, Hkv, D) cache: the
    new token attends to positions [0, cache_len) (optionally only the last
    ``window`` of them).  q: (B, Hq, D) -> (B, Hq, D)."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    cache_len = per_slot(cache_len, B, q.device)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    kpos = torch.arange(S, device=q.device)[None]
    valid = kpos < cache_len[:, None]
    if window is not None:
        valid = valid & (kpos >= cache_len[:, None] - window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    out = torch.where(valid.any(-1)[:, None, None, None], out, 0.0)
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention_split_ref(q, k_cache, v_cache, cache_len, *,
                               nsplit: int, split_len: int,
                               window: Optional[int] = None,
                               softmax_scale=None):
    """``decode_attention_ref`` computed as the CUDA kernel orders it: the
    keys in ``nsplit`` splits of ``split_len`` (``plan_splits``), a partial
    state (m, l, acc) per split over its visible keys, then the splits that
    overlap a slot's visible range merged in ascending split order and
    finalized as acc / max(l, 1e-37) (zeros where no key is visible).  In
    float32; only the tests use it."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    cache_len = per_slot(cache_len, B, q.device)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    kpos = torch.arange(S, device=q.device)[None]
    valid = kpos < cache_len[:, None]
    if window is not None:
        valid = valid & (kpos >= cache_len[:, None] - window)
    v = v_cache.float()
    parts = []                            # per split: (seen, m, l, acc)
    for i in range(nsplit):
        lo, hi = i * split_len, min((i + 1) * split_len, S)
        ok = valid[:, lo:hi]                                   # (B, n)
        sc = torch.where(ok[:, None, None], s[..., lo:hi], NEG_INF)
        m_s = sc.amax(-1)
        p = torch.where(ok[:, None, None], torch.exp(sc - m_s[..., None]),
                        0.0)
        parts.append((ok.any(-1)[:, None, None], m_s, p.sum(-1),
                      torch.einsum("bhgs,bshd->bhgd", p, v[:, lo:hi])))
    # the merge: the largest m of the splits that see a key, then their
    # sums rescaled to it, in ascending split order
    m = torch.full((B, Hkv, G), NEG_INF, device=q.device)
    for seen, m_s, _, _ in parts:
        m = torch.where(seen, torch.maximum(m, m_s), m)
    l = torch.zeros(B, Hkv, G, device=q.device)
    acc = torch.zeros(B, Hkv, G, D, device=q.device)
    for seen, m_s, l_s, acc_s in parts:
        f = torch.where(seen, torch.exp(m_s - m), 0.0)
        l = l + l_s * f
        acc = acc + acc_s * f[..., None]
    out = acc / l.clamp_min(1e-37)[..., None]
    out = torch.where(valid.any(-1)[:, None, None, None], out, 0.0)
    return out.reshape(B, Hq, D).to(q.dtype)


def chunk_attention_ref(q, k_cache, v_cache, start, chunk_len, *,
                        prefix_len: int = 0, softmax_scale=None):
    """Chunked-prefill attention: T query rows at absolute positions
    ``start + i`` against a (B, S, Hkv, D) cache that already holds the
    chunk's own K/V.  A key at kp is visible to row i iff
        (kp <= start + i  or  kp < prefix_len)
    and kp < start + chunk_len and i < chunk_len.  Rows that see nothing
    (i >= chunk_len) are zeros.  q: (B, T, Hq, D) -> (B, T, Hq, D)."""
    B, T, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    dev = q.device
    start = per_slot(start, B, dev)
    chunk_len = per_slot(chunk_len, B, dev)
    rows = torch.arange(T, device=dev)
    qpos = start[:, None] + rows[None]                      # (B, T)
    kpos = torch.arange(S, device=dev)[None, None]          # (1, 1, S)
    ok = kpos <= qpos[..., None]
    if prefix_len:
        ok = ok | (kpos < prefix_len)
    ok = ok & (kpos < (start + chunk_len)[:, None, None])
    ok = ok & (rows[None, :, None] < chunk_len[:, None, None])
    qg = q.reshape(B, T, Hkv, G, D).float()
    s = torch.einsum("blhgd,bshd->bhgls", qg, k_cache.float()) * scale
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgls,bshd->blhgd", p, v_cache.float())
    any_visible = ok.any(dim=-1)[:, :, None, None, None]
    out = torch.where(any_visible, out, 0.0)
    return out.reshape(B, T, Hq, D).to(q.dtype)


def paged_gather_ref(pages, block_tables):
    """Dense gather: pages (P, bs, *rest) + tables (B, nblk) -> contiguous
    (B, nblk*bs, *rest).  ``rest`` is (Hkv, D) for value pools and (Hkv,)
    for the int8 pools' scale siblings."""
    B, nblk = block_tables.shape
    _, bs, *rest = pages.shape
    g = pages[block_tables.long()]                 # (B, nblk, bs, *rest)
    return g.reshape(B, nblk * bs, *rest)


def mask_block_tables(block_tables, valid_len, block_size: int, trash: int):
    """Route every table entry wholly past ``valid_len`` to the ``trash``
    block before a gather, so the gather streams up-to-len rows plus one
    hot page instead of each slot's full pool (masked positions never
    survive the softmax, so outputs are unchanged)."""
    B, nblk = block_tables.shape
    starts = torch.arange(nblk, dtype=torch.int32,
                          device=block_tables.device)[None] * block_size
    valid_len = per_slot(valid_len, B, block_tables.device)
    return torch.where(starts < valid_len[:, None], block_tables,
                       torch.full_like(block_tables, trash))


def _gather_pool(pages, block_tables, valid_len):
    """One pool's dense (B, nblk*bs, Hkv, D) view through a length-masked
    table; a ``QuantPages`` pool gathers values and scales through the same
    table and dequantizes to f32 (what the int8 kernels do in registers)."""
    bs, trash = pages.shape[1], pages.shape[0] - 1
    bt = mask_block_tables(block_tables, valid_len, bs, trash)
    if isinstance(pages, QuantPages):
        return dequantize(paged_gather_ref(pages.values, bt),
                          paged_gather_ref(pages.scales, bt))
    return paged_gather_ref(pages, bt)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, cache_len,
                               *, softmax_scale=None):
    """Plain version of the paged decode kernels (bf16 or ``QuantPages``
    pools): gather each slot's rows, then ``decode_attention_ref``."""
    k = _gather_pool(k_pages, block_tables, cache_len)
    v = _gather_pool(v_pages, block_tables, cache_len)
    return decode_attention_ref(q, k, v, cache_len,
                                softmax_scale=softmax_scale)


def paged_chunk_attention_ref(q, k_pages, v_pages, block_tables, start,
                              chunk_len, *, prefix_len: int = 0,
                              softmax_scale=None):
    """Plain version of the paged chunked-prefill kernels: gather each
    slot's rows below ``start + chunk_len``, then ``chunk_attention_ref``."""
    B = q.shape[0]
    end = per_slot(start, B, q.device) + per_slot(chunk_len, B, q.device)
    k = _gather_pool(k_pages, block_tables, end)
    v = _gather_pool(v_pages, block_tables, end)
    return chunk_attention_ref(q, k, v, start, chunk_len,
                               prefix_len=prefix_len,
                               softmax_scale=softmax_scale)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality)
# ---------------------------------------------------------------------------

def ssd_chunked_ref(x, dt, A, B, C, D=None, *, chunk: int = 128,
                    initial_state=None):
    """Chunked SSD scan: the intra-chunk quadratic part plus the
    inter-chunk state recurrence, in f32.

    x (Bb, L, H, P); dt (Bb, L, H); A (H,); B, C (Bb, L, G, N) with H % G
    == 0 (head h reads group h // (H // G)); D (H,) or None; initial_state
    (Bb, H, P, N) or None.  Padded tail steps get dt = 0, an identity step.
    Returns (y (Bb, L, H, P) in x's dtype, final state (Bb, H, P, N) f32).
    """
    Bb, L, H, P = x.shape
    G, N = B.shape[2:]
    rep = H // G
    Q = min(chunk, L)
    nC = -(-L // Q)
    pad = nC * Q - L

    def padt(a):                        # zero-pad the time axis (1)
        return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))

    xc = padt(x.float()).reshape(Bb, nC, Q, H, P)
    dtc = padt(dt.float()).reshape(Bb, nC, Q, H)
    Bc = padt(B.float().repeat_interleave(rep, dim=2)).reshape(
        Bb, nC, Q, H, N)
    Cc = padt(C.float().repeat_interleave(rep, dim=2)).reshape(
        Bb, nC, Q, H, N)
    cum = torch.cumsum(dtc * A.float()[None, None, None], dim=2)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # intra-chunk, every chunk at once: M[t,s] = exp(cum_t - cum_s) *
    # (C_t . B_s) * dt_s.  The exponent is masked before the exp (the
    # reference masks after it): the same values, but where s > t the
    # exponent grows with the chunk past f32's exp range, and exp(inf)
    # times a zero cotangent would make the gradient NaN
    decay = torch.exp(torch.where(tri[None, None, :, :, None],
                                  cum[:, :, :, None] - cum[:, :, None],
                                  -torch.inf))        # (Bb, nC, t, s, H)
    cb = torch.einsum("bcthn,bcshn->bctsh", Cc, Bc)
    y = torch.einsum("bctsh,bcshp->bcthp", decay * cb * dtc[:, :, None],
                     xc)
    # each chunk's own state: sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
    last = cum[:, :, -1]                                   # (Bb, nC, H)
    w = torch.exp(last[:, :, None] - cum) * dtc            # (Bb, nC, Q, H)
    S = torch.einsum("bcshp,bcshn->bchpn", xc * w[..., None], Bc)
    # the state carried into each chunk, chunk after chunk
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    carried = []
    for c in range(nC):
        carried.append(h)
        h = h * torch.exp(last[:, c])[..., None, None] + S[:, c]
    # inter-chunk: the carried state's contribution
    y = y + torch.einsum("bcthn,bchpn->bcthp", Cc,
                         torch.stack(carried, dim=1)) \
        * torch.exp(cum)[..., None]
    y = y.reshape(Bb, nC * Q, H, P)[:, :L]
    if D is not None:
        y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssd_decode_step_ref(state, x_t, dt_t, A, B_t, C_t, D=None):
    """One recurrent SSD step, the state updated IN PLACE: unlike the
    reference's functional step this allocates no second state (at 128
    slots of mamba2-2.7b one layer's state is 335 MB).

    state (Bb, H, P, N) f32; x_t (Bb, H, P); dt_t (Bb, H); B_t, C_t
    (Bb, G, N).  A slot with dt = 0 keeps its state exactly (exp(0) = 1,
    and it adds 0).  Returns (y_t (Bb, H, P) in x_t's dtype, state)."""
    if state.dtype != torch.float32:
        raise ValueError(f"the SSD state must be f32, got {state.dtype}")
    H = state.shape[1]
    rep = H // B_t.shape[1]
    Bh = B_t.float().repeat_interleave(rep, dim=1)           # (Bb, H, N)
    Ch = C_t.float().repeat_interleave(rep, dim=1)
    xf, dtf = x_t.float(), dt_t.float()
    dA = torch.exp(dtf * A.float()[None])
    state.mul_(dA[..., None, None]).addcmul_(
        (xf * dtf[..., None])[..., None], Bh[:, :, None])
    y = torch.matmul(state, Ch[..., None])[..., 0]
    if D is not None:
        y = y + xf * D.float()[None, :, None]
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# grouped (per-expert) matmul
# ---------------------------------------------------------------------------

def grouped_matmul_ref(lhs, rhs):
    """(E, C, K) @ (E, K, N) -> (E, C, N) in lhs's dtype, summed in f32."""
    out = torch.einsum("eck,ekn->ecn", lhs.float(), rhs.float())
    return out.to(lhs.dtype)
