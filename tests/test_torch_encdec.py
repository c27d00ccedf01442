"""Whisper (encoder-decoder) parity between the PyTorch port and the JAX
reference.

The config is ``reduced(whisper-large-v3)`` (2 encoder and 2 decoder
layers, d_model 128, encoder_len 64) in float32.  Weights are built by the
reference (``encdec.init``) and carried over with
``repro_torch.bridge.params_from_jax``; token ids and frame embeddings are
made with numpy from a seed.  On the CPU the port runs its plain versions.
Tolerances: the encoder memory, per-step logits, page pools and cross K/V
to atol = rtol = 1e-4 (the frameworks sum in other orders); greedy token
chains exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.allocator import ParallelPlan as JPlan
from repro.core.categories import Sensitivity as JSens
from repro.core.categories import TaskCategory as JCat
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.launch import serve
from repro_torch.models import encdec, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_api
from repro_torch.serving.arena import KVArena
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _cfg():
    return dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config("whisper-large-v3")),
        dtype="float32", param_dtype="float32")


def _params(cfg, seed=11):
    params = jencdec.init(jax.random.PRNGKey(seed), cfg)
    return params, bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                          _mirror(cfg), "cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_init_keeps_reference_tree():
    cfg = _cfg()
    jp = jax.tree.map(np.asarray, jencdec.init(jax.random.PRNGKey(0), cfg))
    tp = encdec.init(0, _mirror(cfg), device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(k): tuple(np.shape(v))
                           for k, v in
                           jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(tp) == shapes(jp)
    assert "wqkv" not in tp["dec_blocks"]["cross_attn"]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_layer_matches_reference(cross, causal):
    """``layers.attention`` without rope: self-attention, and with
    ``kv_x`` cross-attention over a longer memory (the decoder block's
    cross projections, ``init_attention(cross=True)``)."""
    cfg = _cfg()
    jp, tp = _params(cfg)
    blocks = "dec_blocks" if cross else "enc_blocks"
    name = "cross_attn" if cross else "attn"
    jl = jax.tree.map(lambda a: a[1], jp[blocks][name])
    tl = {k: v[1] for k, v in tp[blocks][name].items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, cfg.encoder_len, cfg.d_model)).astype(
        np.float32) if cross else None
    want, _ = jlayers.attention(
        jl, cfg, jnp.asarray(x), causal=causal, use_rope=False, impl="ref",
        kv_x=None if mem is None else jnp.asarray(mem))
    got = layers.attention(tl, _mirror(cfg), _t(x), causal=causal,
                           kv_x=None if mem is None else _t(mem))
    _close(got, want)


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
def test_encode_matches_reference(impl):
    cfg = _cfg()
    jp, tp = _params(cfg)
    emb = np.random.default_rng(0).normal(
        size=(2, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    want = jencdec.encode(jp, cfg, jnp.asarray(emb), impl=impl)
    got = encdec.encode(tp, _mirror(cfg), _t(emb))
    _close(got, want)


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
def test_chunks_then_decode_match_reference(impl):
    """Two ragged chunks (the first carries the frame embeddings and
    projects the cross K/V), then three fused decode steps.  Slot 2 never
    gets a prompt (chunk length 0) and is dead in every decode step: the
    port attends it to nothing on both sides, so only the live rows'
    logits are compared; its length stays 0 and its writes land in the
    trash page, which is left out of the pool comparison."""
    cfg = _cfg()
    tcfg = _mirror(cfg)
    jp, tp = _params(cfg)
    rng = np.random.default_rng(1)
    B, bs, nblk = 3, 8, 6
    P1 = B * nblk + 1
    tables = rng.permutation(B * nblk).reshape(B, nblk).astype(np.int32)
    pool = (cfg.num_layers, P1, bs, cfg.num_kv_heads, cfg.head_dim)
    xkv = (cfg.num_layers, B, cfg.encoder_len, cfg.num_kv_heads,
           cfg.head_dim)
    jcache = {"k": jnp.zeros(pool), "v": jnp.zeros(pool),
              "cross_k": jnp.zeros(xkv), "cross_v": jnp.zeros(xkv),
              "len": jnp.zeros((B,), jnp.int32)}
    tcache = {"k": torch.zeros(pool), "v": torch.zeros(pool),
              "cross_k": torch.zeros(xkv), "cross_v": torch.zeros(xkv),
              "len": torch.zeros((B,), dtype=torch.int32)}
    jbt, tbt = jnp.asarray(tables), _t(tables)
    emb = rng.normal(size=(B, cfg.encoder_len, cfg.d_model)).astype(
        np.float32)

    def same(jl, tl, rows):
        _close(tl[rows], np.asarray(jl)[rows])
        for n in ("k", "v"):
            _close(tcache[n][:, :-1], np.asarray(jcache[n])[:, :-1])
        for n in ("cross_k", "cross_v"):
            _close(tcache[n], jcache[n])
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))

    for T, cl, first in ((16, [16, 9, 0], True), (8, [8, 5, 0], False)):
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        jb = {"tokens": jnp.asarray(toks)}
        tb = {"tokens": _t(toks)}
        if first:
            jb["embeddings"] = jnp.asarray(emb)
            tb["embeddings"] = _t(emb)
        jl, jcache = jencdec.prefill_chunk_paged(
            jp, cfg, jb, jcache, jbt, chunk_len=jnp.asarray(cl, jnp.int32),
            block_size=bs, impl=impl)
        tl, tcache = encdec.prefill_chunk_paged(
            tp, tcfg, tb, tcache, tbt,
            chunk_len=torch.tensor(cl, dtype=torch.int32), block_size=bs)
        same(jl, tl, [0, 1])
    live = np.array([True, True, False])
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jl, jcache = jencdec.decode_step_paged(
            jp, cfg, jnp.asarray(tok), jcache, jbt, jnp.asarray(live),
            block_size=bs, impl=impl)
        tl, tcache = encdec.decode_step_paged(
            tp, tcfg, _t(tok), tcache, tbt, _t(live), block_size=bs)
        same(jl, tl, [0, 1])
    assert tcache["len"].tolist() == [16 + 8 + 3, 9 + 5 + 3, 0]


def test_unported_entry_points_raise():
    """(The name predates their ports.)  The training forward
    ``forward_hidden`` (item 12), the one-shot ``prefill`` and the dense
    ``prefill_chunk`` and ``decode_step`` (item 11) are the registry's
    entry points; ``tests/test_torch_train_families.py`` holds training
    to the reference."""
    api = model_api(_mirror(_cfg()))
    assert (api.prefill, api.prefill_chunk, api.decode_step,
            api.forward_hidden) == (encdec.prefill, encdec.prefill_chunk,
                                    encdec.decode_step,
                                    encdec.forward_hidden)


def test_cross_state_bytes_at_full_width():
    """At whisper-large-v3's full width the arena keeps the cross K/V as
    per-slot bf16 state: 32 layers x 1500 x 20 heads x 64 x 2 B x 2 =
    245.76 MB a slot (31.46 GB at 128 slots, 125.8 GB at the plan's 512),
    and pages only the decoder K/V (int8 here: 87,040 B a token)."""
    cfg = get_config("whisper-large-v3")
    arena = KVArena(cfg, encdec.init_cache, capacity=128, max_seq_len=256,
                    block_size=32, kv_dtype="int8", device="meta")
    assert arena.state_slot_bytes == 245_760_000
    assert [tuple(s.shape) for s in arena.state] \
        == [(32, 128, 1500, 20, 64)] * 2
    assert all(s.dtype == torch.bfloat16 for s in arena.state)
    assert arena.token_bytes == 32 * 2 * (20 * 64 + 20 * 4)
    assert arena.pool_blocks == 1024
    assert len(arena.pages) == 2


WAVE = [(3, 6), (9, 5), (17, 8), (30, 4), (8, 7), (25, 6), (12, 5)]


def _plan_args(kv_dtype, bs):
    return dict(bs=bs, mf=2, dp=1, kv_dtype=kv_dtype)


def _runtimes(kv_dtype, bs=4):
    cfg = _cfg()
    jp, tp = _params(cfg)
    args = _plan_args(kv_dtype, bs)
    jplan = JPlan(service="whisper", category=JCat(JSens.FREQUENCY, False),
                  **args)
    tplan = ParallelPlan(
        service="whisper",
        category=TaskCategory(Sensitivity.FREQUENCY, False), **args)
    kw = dict(max_seq_len=48, block_size=8)
    return (cfg, JRuntime(cfg, jp, jplan, impl="ref", prefix_cache=0, **kw),
            ServiceRuntime(_mirror(cfg), tp, tplan, device="cpu",
                           prefix_cache=0, **kw))


def _requests(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), new,
             rng.normal(size=(cfg.encoder_len, cfg.d_model)).astype(
                 np.float32)) for n, new in lens]


def _serve(runtime, request_cls, reqs, rids=None):
    rids = range(len(reqs)) if rids is None else rids
    for rid, (prompt, new, emb) in zip(rids, reqs):
        runtime.submit(request_cls(rid=rid, tokens=prompt,
                                   max_new_tokens=new, stream=rid,
                                   extras={"embeddings": emb}))
    return {r.rid: r for r in runtime.drain()}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_request_wave_matches_reference(kv_dtype):
    """7 requests with their own frame embeddings over 4 slots: slots are
    evicted and reused, paged-native with chunk buckets (8, 16, 32).
    Greedy tokens and the host counters equal the reference's."""
    cfg, jrt, trt = _runtimes(kv_dtype)
    reqs = _requests(cfg, WAVE, seed=3)
    want = _serve(jrt, JRequest, reqs)
    got = _serve(trt, GenerationRequest, reqs)
    assert sorted(got) == sorted(want) == list(range(len(WAVE)))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
    assert jrt.paged_native and trt.paged_native
    assert trt.chunk_buckets == jrt.chunk_buckets
    for name in ("decode_steps", "prefill_chunk_calls",
                 "prefill_tokens_computed", "chunk_write_bytes"):
        assert getattr(trt, name) == getattr(jrt, name), name
    ja, ta = jrt.groups[0].arena, trt.groups[0].arena
    assert ta.state_slot_bytes == ja.state_slot_bytes > 0
    assert ta.token_bytes == ja.token_bytes
    np.testing.assert_array_equal(ta.lens.numpy(), np.asarray(ja.lens))


def test_reused_slot_serves_as_a_fresh_one():
    """One slot: the second request runs in the slot the first one left,
    after its eviction.  Its tokens equal those it gets alone in a fresh
    runtime (and the reference's), and the slot's cross K/V are its own
    memory's projection, not the first tenant's."""
    cfg, jrt, trt = _runtimes("bf16", bs=1)
    first, second = _requests(cfg, [(20, 6), (11, 7)], seed=4)
    got = _serve(trt, GenerationRequest, [first, second])
    assert [r.group for r in got.values()] == [0, 0]
    _, _, fresh = _runtimes("bf16", bs=1)
    alone = _serve(fresh, GenerationRequest, [second], rids=[1])
    want = _serve(jrt, JRequest, [first, second])
    np.testing.assert_array_equal(got[1].tokens, alone[1].tokens)
    np.testing.assert_array_equal(got[1].tokens, want[1].tokens)
    np.testing.assert_array_equal(got[0].tokens, want[0].tokens)
    tcfg, ta = trt.cfg, trt.groups[0].arena
    memory = encdec.encode(trt.params, tcfg, _t(second[2])[None])
    lp = trt.params["dec_blocks"]["cross_attn"]
    for i in range(tcfg.num_layers):
        _close(ta.state[0][i, 0],
               (memory[0] @ lp["wk"][i]).reshape(
                   tcfg.encoder_len, tcfg.num_kv_heads, tcfg.head_dim)
               .numpy())


def test_submit_rejects_audio_requests_without_embeddings():
    cfg, _, trt = _runtimes("bf16")
    prompt = np.arange(5, dtype=np.int32)
    for extras in (None, {}, {"embeddings": np.zeros((3, cfg.d_model))}):
        with pytest.raises(ValueError, match="embeddings"):
            trt.submit(GenerationRequest(rid=0, tokens=prompt,
                                         max_new_tokens=2, extras=extras))
    assert trt.pending() == 0


def test_launcher_serves_whisper_on_cpu(capsys):
    rc = serve.main(["--device", "cpu", "--archs", "whisper-large-v3",
                     "--requests", "3", "--max-new-tokens", "3",
                     "--max-seq-len", "32"])
    assert rc == 0
    assert "served 3/3 requests" in capsys.readouterr().out


def test_registry_serves_audio_paged_native():
    api = model_api(_mirror(_cfg()))
    assert api.prefill_chunk_paged is encdec.prefill_chunk_paged
    assert api.decode_step_paged is encdec.decode_step_paged
    assert api.prefill_chunk is encdec.prefill_chunk
    assert api.decode_step is encdec.decode_step
