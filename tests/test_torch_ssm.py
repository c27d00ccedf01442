"""Mamba-2 (SSM) parity between the PyTorch port and the JAX reference.

Weights are built by the reference (``model_api(cfg).init``) and carried
over with ``repro_torch.bridge.params_from_jax``; inputs are made with
numpy from a seed.  Everything here is float32 on the CPU, where the port
runs its plain versions.  Tolerances: the SSD scan's y and state to 1e-5
(the reference's Pallas kernel picks another chunk length for short
inputs, and the frameworks sum in other orders); per-step logits and the
model's conv and SSD state to 1e-4; greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import toy_config
from repro import configs as jconfigs
from repro.core.allocator import ParallelPlan as JPlan
from repro.core.categories import Sensitivity as JSens
from repro.core.categories import TaskCategory as JCat
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jssm
from repro.models.registry import model_api as jmodel_api
from repro.serving.arena import KVArena as JArena
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro_torch import bridge
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_api
from repro_torch.serving.arena import KVArena
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

SCAN_TOL = 1e-5
MODEL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _ssm_cfg(**over):
    base = dict(family="ssm", ssm_state=16, ssm_headdim=16, ssm_chunk=32)
    base.update(over)
    return toy_config(**base)


def _params(cfg, seed=7):
    params = jmodel_api(cfg).init(jax.random.PRNGKey(seed), cfg)
    return params, bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                          _mirror(cfg), "cpu")


def test_bridge_keeps_f32_leaves_of_bf16_ssm():
    """A bf16 SSM config keeps ``A_log``, ``dt_bias`` and ``D`` in f32:
    every leaf crosses with the reference array's own dtype and bits."""
    cfg = jconfigs.reduced(jconfigs.get_config("mamba2-2.7b"))
    assert cfg.param_dtype == "bfloat16"
    params = jax.tree.map(np.asarray, jmodel_api(cfg).init(
        jax.random.PRNGKey(0), cfg))
    tp = bridge.params_from_jax(params, _mirror(cfg), "cpu")
    blocks = tp["blocks"]
    for name in ("A_log", "dt_bias", "D"):
        assert blocks[name].dtype == torch.float32
    assert blocks["in_proj"].dtype == torch.bfloat16
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, a in flat:
        node = tp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.float().numpy(),
                                      a.astype(np.float32))


SCAN_CASES = {
    # id: (Bb, L, H, G, chunk)
    "shorter_than_8": (2, 5, 4, 1, 32),
    "chunk_multiple": (1, 64, 4, 1, 32),
    "ragged_two_chunks": (2, 50, 4, 1, 32),
    "groups": (1, 40, 4, 2, 32),
    "three_chunks_groups": (2, 130, 4, 2, 64),
}


def _scan_inputs(Bb, L, H, G, P=16, N=16, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, Bm, Cm = f(Bb, L, H, P), f(Bb, L, G, N) * 0.5, f(Bb, L, G, N) * 0.5
    dt = np.log1p(np.exp(f(Bb, L, H))) * 0.5
    A = -np.exp(f(H) * 0.5)
    D = f(H)
    h0 = f(Bb, H, P, N)
    return x, dt, A, Bm, Cm, D, h0


@pytest.mark.parametrize("with_state", [True, False],
                         ids=["initial_state", "zero_state"])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_ssd_scan_matches_reference(case, with_state):
    """The port's ``ssd_scan`` on the CPU against the reference's Pallas
    kernel in interpret mode and its plain ``ssd_chunked_ref``."""
    Bb, L, H, G, chunk = SCAN_CASES[case]
    x, dt, A, Bm, Cm, D, h0 = _scan_inputs(Bb, L, H, G)
    h0 = h0 if with_state else None
    ty, th = ops.ssd_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), _t(D),
                          chunk=chunk,
                          initial_state=None if h0 is None else _t(h0))
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    for fn in (lambda: ssd_scan_pallas(*jargs, chunk=chunk,
                                       initial_state=jh0, interpret=True),
               lambda: jref.ssd_chunked_ref(*jargs, chunk=chunk,
                                            initial_state=jh0)):
        wy, wh = fn()
        np.testing.assert_allclose(ty.numpy(), np.asarray(wy),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(wh),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)


def test_ssd_decode_step_matches_reference():
    """In place on the port's side; G = 2 groups over 4 heads."""
    rng = np.random.default_rng(1)
    Bb, H, G, P, N = 3, 4, 2, 16, 16
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    state, x, B, C = f(Bb, H, P, N), f(Bb, H, P), f(Bb, G, N), f(Bb, G, N)
    dt, A, D = np.abs(f(Bb, H)), -np.abs(f(H)), f(H)
    wy, wstate = jref.ssd_decode_step_ref(
        *(jnp.asarray(a) for a in (state, x, dt, A, B, C, D)))
    ts = _t(state)
    ty, ts2 = ops.ssd_decode_step(ts, _t(x), _t(dt), _t(A), _t(B), _t(C),
                                  _t(D))
    assert ts2 is ts                                  # updated in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(wy), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(wstate),
                               atol=SCAN_TOL, rtol=SCAN_TOL)


def test_conv_step_and_chunk_conv_match_reference():
    """The decode conv step, and one mamba block's chunk (causal conv
    primed with the carried tail, ragged ``chunk_len``, new tail)."""
    cfg = _ssm_cfg()
    jp, tp = _params(cfg)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"])
    tl = {k: (v[0] if not isinstance(v, dict)
              else {kk: vv[0] for kk, vv in v.items()})
          for k, v in tp["blocks"].items()}
    rng = np.random.default_rng(2)
    ch, k = ssm.conv_channels(_mirror(cfg)), cfg.ssm_conv_kernel
    conv = rng.normal(size=(2, k - 1, ch)).astype(np.float32)
    u = rng.normal(size=(2, ch)).astype(np.float32)
    wy, wstate = jssm._conv_step(jl, jnp.asarray(conv), jnp.asarray(u))
    ty, tstate = ssm._conv_step(tl, _t(conv), _t(u))
    np.testing.assert_allclose(ty.numpy(), np.asarray(wy), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(wstate))

    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    state = rng.normal(size=(2, cfg.ssm_nheads, cfg.ssm_headdim,
                             cfg.ssm_state)).astype(np.float32)
    cl = np.array([12, 2], np.int32)           # the second is shorter than k
    wout, wtail, wst = jssm.mamba_block_chunk(
        jl, cfg, jnp.asarray(x), jnp.asarray(conv), jnp.asarray(state),
        jnp.asarray(cl), impl="ref")
    tout, ttail, tst = ssm.mamba_block_chunk(
        tl, _mirror(cfg), _t(x), _t(conv), _t(state), _t(cl))
    np.testing.assert_allclose(tout.numpy(), np.asarray(wout),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(ttail.numpy(), np.asarray(wtail),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(wst),
                               atol=MODEL_TOL, rtol=MODEL_TOL)


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
def test_chunks_then_decode_match_reference(impl):
    """Two ragged chunks (the first, 40 tokens, crosses the 32-token
    ``ssm_chunk``), then decode steps; the last one with slot 1 dead,
    whose state must stay exactly as it was."""
    cfg = _ssm_cfg()
    tcfg = _mirror(cfg)
    jp, tp = _params(cfg)
    rng = np.random.default_rng(3)
    B = 2
    jcache = jssm.init_cache(cfg, B, 64)
    jcache["len"] = jnp.zeros((B,), jnp.int32)
    tcache = ssm.init_cache(tcfg, B, 64, device="cpu")
    tcache["len"] = torch.zeros((B,), dtype=torch.int32)

    def same(jl, tl, tc):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        for n in ("conv", "ssd"):
            np.testing.assert_allclose(tc[n].numpy(),
                                       np.asarray(jcache[n]),
                                       atol=MODEL_TOL, rtol=MODEL_TOL)
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jcache["len"]))

    for T, cl in ((40, [40, 23]), (16, [16, 9])):
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        jl, jcache = jssm.prefill_chunk(
            jp, cfg, {"tokens": jnp.asarray(toks)}, jcache,
            chunk_len=jnp.asarray(cl, jnp.int32), impl=impl)
        tl, tcache = ssm.prefill_chunk(
            tp, tcfg, {"tokens": _t(toks)}, tcache,
            chunk_len=torch.tensor(cl, dtype=torch.int32))
        same(jl, tl, tcache)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jl, jcache = jssm.decode_step(jp, cfg, jnp.asarray(tok), jcache,
                                      impl=impl)
        tl, tcache = ssm.decode_step(tp, tcfg, _t(tok), tcache)
        same(jl, tl, tcache)
    before = {n: tcache[n][:, 1].clone() for n in ("conv", "ssd")}
    tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
    jl, jcache = jssm.decode_step(jp, cfg, jnp.asarray(tok), jcache,
                                  impl=impl)
    tl, tcache = ssm.decode_step(tp, tcfg, _t(tok), tcache,
                                 live=torch.tensor([True, False]))
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl[0]),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    for n in ("conv", "ssd"):
        np.testing.assert_allclose(tcache[n][:, 0].numpy(),
                                   np.asarray(jcache[n][:, 0]),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        assert torch.equal(tcache[n][:, 1], before[n])
    assert tcache["len"].tolist() == [int(jcache["len"][0]),
                                      int(jcache["len"][1]) - 1]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_arena_state_leaves_match_reference(kv_dtype):
    """State leaves: shapes, dtypes (never quantized), byte counts, and
    the cache dict they assemble into."""
    cfg = _ssm_cfg()
    kw = dict(capacity=4, max_seq_len=80, block_size=8, kv_dtype=kv_dtype)
    ja = JArena(cfg, jssm.init_cache, **kw)
    ta = KVArena(_mirror(cfg), ssm.init_cache, device="cpu", **kw)
    assert [tuple(s.shape) for s in ta.state] \
        == [tuple(s.shape) for s in ja.state] \
        == [(2, 4, 3, 160), (2, 4, 8, 16, 16)]
    assert [str(s.dtype).split(".")[-1] for s in ta.state] \
        == [str(s.dtype) for s in ja.state] == ["float32", "float32"]
    assert ta.pages == [] and ja.pages == []
    assert ta.state_slot_bytes == ja.state_slot_bytes
    assert ta.token_bytes == ja.token_bytes == 0
    for n in (1, 9, 33):
        assert ta.chunk_bytes(n) == ja.chunk_bytes(n)
        assert ta.slot_bytes(n) == ja.slot_bytes(n)
    cache = ta.assemble(ta.pages, ta.state, ta.lens)
    assert cache["conv"] is ta.state[0] and cache["ssd"] is ta.state[1]
    assert cache["len"] is ta.lens
    pages, state = ta.disassemble(cache)
    assert pages == [] and state[0] is ta.state[0] \
        and state[1] is ta.state[1]
    ta.state[1][:, 2] = 1.0
    for view in ta.slot_state(2):
        assert view.shape[1] == 1
    ta.zero_state(2)
    assert not ta.state[1].any()


WAVE = [(3, 6), (9, 5), (17, 8), (30, 4), (8, 7), (25, 6), (40, 5)]


def _serve(runtime, request_cls, prompts, streams):
    for rid, ((prompt, new), stream) in enumerate(zip(prompts, streams)):
        runtime.submit(request_cls(rid=rid, tokens=prompt,
                                   max_new_tokens=new, stream=stream))
    return {r.rid: r for r in runtime.drain()}


def _runtimes(dp, kv_dtype="int8"):
    cfg = _ssm_cfg()
    jp, tp = _params(cfg)
    cat = dict(bs=4, mf=2, dp=dp, sticky=True, kv_dtype=kv_dtype)
    jplan = JPlan(service="toy", category=JCat(JSens.FREQUENCY, False),
                  **cat)
    tplan = ParallelPlan(service="toy",
                         category=TaskCategory(Sensitivity.FREQUENCY, False),
                         **cat)
    kw = dict(max_seq_len=80, block_size=8)
    return (cfg, JRuntime(cfg, jp, jplan, impl="ref", prefix_cache=0, **kw),
            ServiceRuntime(_mirror(cfg), tp, tplan, device="cpu",
                           prefix_cache=0, **kw))


def test_request_wave_matches_reference():
    """7 requests over 4 slots: eviction and re-admission, so three slots
    are reused and must start from zeroed state; the state path
    (``native=False``) with chunk buckets (8, 16, 32)."""
    cfg, jrt, trt = _runtimes(dp=1)
    rng = np.random.default_rng(8)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), new)
               for n, new in WAVE]
    streams = list(range(1, len(WAVE) + 1))
    want = _serve(jrt, JRequest, prompts, streams)
    got = _serve(trt, GenerationRequest, prompts, streams)
    assert sorted(got) == sorted(want) == list(range(len(WAVE)))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
    assert not jrt.paged_native and not trt.paged_native
    assert trt.chunk_buckets == jrt.chunk_buckets == (8, 16, 32)
    for name in ("decode_steps", "prefill_chunk_calls",
                 "prefill_tokens_computed", "chunk_write_bytes"):
        assert getattr(trt, name) == getattr(jrt, name), name
    ja, ta = jrt.groups[0].arena, trt.groups[0].arena
    assert [tuple(s.shape) for s in ta.state] \
        == [tuple(s.shape) for s in ja.state]
    assert [str(s.dtype).split(".")[-1] for s in ta.state] \
        == [str(s.dtype) for s in ja.state]
    assert ta.state_slot_bytes == ja.state_slot_bytes > 0
    np.testing.assert_array_equal(ta.lens.numpy(), np.asarray(ja.lens))


def test_sticky_sessions_route_as_reference():
    """A stateful plan with two DP groups: each request lands in the same
    group as in the reference, sessions that repeat stay on their group,
    and every pin is released once the session's requests are gone."""
    cfg, jrt, trt = _runtimes(dp=2)
    rng = np.random.default_rng(9)
    lens = [(5, 4), (12, 3), (7, 5), (20, 2), (3, 6), (9, 3), (14, 4),
            (6, 5), (11, 2), (4, 3)]
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), new)
               for n, new in lens]
    streams = [1, 2, 1, 3, 1, 2, 4, 1, 5, 3]
    want = _serve(jrt, JRequest, prompts, streams)
    got = _serve(trt, GenerationRequest, prompts, streams)
    assert sorted(got) == sorted(want) == list(range(len(lens)))
    groups = {rid: r.group for rid, r in got.items()}
    assert groups == {rid: r.group for rid, r in want.items()}
    assert {groups[rid] for rid, s in enumerate(streams) if s == 1} \
        == {groups[0]}
    assert len(set(groups.values())) == 2
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
    assert trt.router.sessions() == jrt.router.sessions() == 0


def test_launcher_serves_reference_pair_on_cpu(capsys):
    """The reference launcher's default ``--archs`` pair, reduced, on the
    CPU."""
    rc = serve.main(["--device", "cpu", "--archs", "minicpm-2b,mamba2-2.7b",
                     "--requests", "4", "--max-new-tokens", "3",
                     "--max-seq-len", "32"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out
    assert "mamba2-2.7b" in out


def test_registry_serves_ssm_state_path():
    api = model_api(_mirror(_ssm_cfg()))
    assert api.decode_step_paged is None and api.prefill_chunk_paged is None
    assert api.decode_step is ssm.decode_step
