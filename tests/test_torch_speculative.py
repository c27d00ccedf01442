"""Speculative decoding on the port against the JAX reference.

* ``verify_step_paged``: the dense family's (reduced minicpm-2b) and the
  MoE family's (reduced mixtral-8x7b at a 56-token budget, below its
  64-token window: ROADMAP.md Queue 3) against the reference's, run as the
  reference's tests run it on the CPU (``impl="ref"``, and the dense one
  also through the Pallas chunk kernel in interpret mode), on pools a
  ragged chunk filled first: per-slot chunk lengths with 0 rows, starts
  mid-page, shuffled block tables; the pools are filled by the
  reference's ``prefill_chunk_paged`` and given to both, so that only the
  verify differs.  Logits are held in float32 to rtol = 1e-5 and atol =
  1e-4, ``tests/test_torch_model.py``'s paged-step bound (the frameworks
  sum in other orders: entries near 0 of rows whose largest logits pass
  30 differ by up to 1.4e-5), and the pools to 1e-6; the MoE's logits and
  pools to ``tests/test_torch_moe.py``'s 1e-4; the lengths exactly
  (unchanged), and the MoE's expert-capacity drops exactly.
* The engine: the reference's ``ServiceRuntime`` and the port's, on the
  float32 toy config with the reference's weights carried over by the
  bridge, step in lockstep over a seven-request wave with a self-draft
  (greedy) and with a separately initialised 1-layer draft (greedy, and
  stochastic at temperature 0.8, top_k 40).  Every step's
  ``draft_steps``, ``verify_launches``, ``accepted_tokens``,
  ``spec_slots`` and ``spec_degraded`` are equal, so are the totals and
  the chains, and the greedy chains equal the plain engine's.  The same
  holds at a tight ``max_seq_len`` (the tail degrade), on the MoE path, on
  a prefix-cache hit whose shared tail the verify span copies on write,
  and across ``evacuate``.
* ``tests/test_speculative.py``'s speculation scenarios (bit-identical
  greedy, stochastic determinism, the category gate, parking degrades
  without corrupting) on both engines, and the constructor's gates.

Every comparison is exact except the logits and pools above.
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
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.registry import model_api as jmodel_api
from repro.serving import sampler as J
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro_torch import bridge
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.models import moe, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_api
from repro_torch.serving import sampler as S
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

STOCH = (0.8, 40)
GREEDY = (0.0, 0)
STEP_FIELDS = ("draft_steps", "verify_launches", "accepted_tokens",
               "spec_slots", "spec_degraded", "decode_steps",
               "prefill_chunk_tokens", "admission_copy_bytes",
               "prefix_cow_blocks", "prefix_hits", "evicted")
TOTALS = ("draft_steps", "verify_launches", "accepted_tokens",
          "draft_prefill_tokens", "spec_degraded", "decode_steps",
          "prefill_chunk_calls", "prefill_tokens_computed",
          "admission_copy_bytes")


def _t(a):
    return torch.from_numpy(np.array(a))


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _f32(cfg, **over):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                               **over)


def _reduced(arch, **over):
    return _f32(jconfigs.reduced(jconfigs.get_config(arch)), **over)


def _bridged(cfg, seed):
    jp = jmodel_api(cfg).init(jax.random.PRNGKey(seed), cfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                      _mirror(cfg), "cpu")


# ---------------------------------------------------------------------------
# verify_step_paged
# ---------------------------------------------------------------------------

def _verify_pair(cfg, jmod, tmod, *, B, bs, nblk, fill, verify, impl,
                 seed=1):
    """Fill zero pools with one ragged chunk (``fill`` rows a slot) through
    the reference's ``prefill_chunk_paged``, give the port the same pools,
    then run each framework's ``verify_step_paged`` with T = 5 and
    per-slot ``verify`` chunk lengths; returns both sides' logits, caches,
    the physical rows the live slots wrote and the expert-capacity drops
    the two verify calls counted (0 unless the MoE counters are on)."""
    rng = np.random.default_rng(seed)
    P = B * nblk + 1
    bt = rng.permutation(P - 1).reshape(B, nblk).astype(np.int32)
    shape = (cfg.num_layers, P, bs, cfg.num_kv_heads, cfg.head_dim)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
          "len": jnp.zeros((B,), jnp.int32)}
    tcfg = _mirror(cfg)
    jp, tp = _bridged(cfg, seed)
    T0 = max(fill)
    toks = rng.integers(0, cfg.vocab_size, (B, T0)).astype(np.int32)
    _, jc = jmod.prefill_chunk_paged(
        jp, cfg, {"tokens": jnp.asarray(toks)}, jc, jnp.asarray(bt),
        chunk_len=jnp.asarray(fill, jnp.int32), block_size=bs, impl=impl)
    tc = {n: _t(jc[n]) for n in ("k", "v", "len")}
    toks = rng.integers(0, cfg.vocab_size, (B, 5)).astype(np.int32)
    jax.effects_barrier()
    moe.MOE_DROP_STATS.flush()
    drops0 = (jmoe.MOE_DROP_STATS.dropped, moe.MOE_DROP_STATS.dropped)
    jl, jv = jmod.verify_step_paged(
        jp, cfg, {"tokens": jnp.asarray(toks)}, jc, jnp.asarray(bt),
        chunk_len=jnp.asarray(verify, jnp.int32), block_size=bs, impl=impl)
    tl, tv = tmod.verify_step_paged(
        tp, tcfg, {"tokens": _t(toks)}, tc, _t(bt),
        chunk_len=torch.tensor(verify, dtype=torch.int32), block_size=bs)
    jax.effects_barrier()
    moe.MOE_DROP_STATS.flush()
    drops = (jmoe.MOE_DROP_STATS.dropped - drops0[0],
             moe.MOE_DROP_STATS.dropped - drops0[1])
    rows = [(int(bt[b, p // bs]), p % bs) for b in range(B)
            for p in range(fill[b], fill[b] + verify[b])]
    return jl, jv, tl, tv, fill, rows, drops


def _assert_verify_equal(jl, jv, tl, tv, fill, verify, rows, rtol,
                         pool_tol):
    live = np.asarray(verify) > 0
    assert tuple(tl.shape) == tuple(np.shape(jl))
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=1e-4, rtol=rtol)
    # the lengths come back unchanged: acceptance commits them
    np.testing.assert_array_equal(tv["len"].numpy(), fill)
    np.testing.assert_array_equal(np.asarray(jv["len"]), fill)
    for n in "kv":
        got, want = tv[n].numpy(), np.asarray(jv[n])
        # every page but the trash page, the verify's rows among them
        np.testing.assert_allclose(got[:, :-1], want[:, :-1], atol=pool_tol,
                                   rtol=pool_tol)
        blk = [b for b, _ in rows]
        off = [o for _, o in rows]
        assert np.abs(got[:, blk, off]).max() > 0


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
def test_dense_verify_step_matches_reference(impl):
    """Reduced minicpm-2b, 4 slots of 8 blocks of 8 tokens: ragged fills
    (mid-page, at a page end, none), then verify rows for three slots and
    0 for one that holds tokens."""
    cfg = _reduced("minicpm-2b")
    fill, verify = [13, 8, 21, 0], [5, 0, 5, 5]
    out = _verify_pair(cfg, jtransformer, transformer, B=4, bs=8, nblk=8,
                       fill=fill, verify=verify, impl=impl)
    _assert_verify_equal(*out[:5], verify, out[5], 1e-5, 1e-6)


def test_moe_verify_step_matches_reference():
    """Reduced mixtral-8x7b at 7 blocks of 8 tokens (56, below the window):
    each slot's 5 rows are one routing group; logits, pools, lengths and
    the expert-capacity drops equal the reference's."""
    cfg = _reduced("mixtral-8x7b")
    fill, verify = [16, 9, 12, 0], [5, 0, 5, 5]
    was_j, was_t = jmoe._DROP_COUNTER_ENABLED, moe._DROP_COUNTER_ENABLED
    jmoe.enable_drop_counter(True)
    moe.enable_drop_counter(True)
    try:
        out = _verify_pair(cfg, jmoe, moe, B=4, bs=8, nblk=7, fill=fill,
                           verify=verify, impl="ref")
    finally:
        jmoe.enable_drop_counter(was_j)
        moe.enable_drop_counter(was_t)
    _assert_verify_equal(*out[:5], verify, out[5], 1e-4, 1e-4)
    jdrop, tdrop = out[6]
    assert tdrop == jdrop > 0


def test_verify_rows_of_unspeculating_slots_touch_only_the_trash_page():
    """A slot with chunk_len 0 writes nothing outside the trash page; the
    speculating slots' logits and K/V rows are those of 5 decode steps fed
    the same tokens."""
    cfg = _mirror(_reduced("minicpm-2b"))
    _, tp = _bridged(_reduced("minicpm-2b"), 2)
    B, bs, nblk = 3, 8, 4
    P = B * nblk + 1
    rng = np.random.default_rng(3)
    bt = torch.from_numpy(rng.permutation(P - 1).reshape(B, nblk).astype(
        np.int32))
    shape = (cfg.num_layers, P, bs, cfg.num_kv_heads, cfg.head_dim)
    k0, v0 = torch.randn(shape), torch.randn(shape)
    lens = torch.tensor([6, 11, 3], dtype=torch.int32)
    toks = _t(rng.integers(0, cfg.vocab_size, (B, 5)).astype(np.int32))
    kv, vv = k0.clone(), v0.clone()
    lv, cv = transformer.verify_step_paged(
        tp, cfg, {"tokens": toks}, {"k": kv, "len": lens, "v": vv}, bt,
        chunk_len=torch.tensor([5, 0, 5], dtype=torch.int32), block_size=bs)
    kd, vd, ld = k0.clone(), v0.clone(), lens.clone()
    live = torch.tensor([True, False, True])
    steps = []
    for j in range(5):
        lg, c = transformer.decode_step_paged(
            tp, cfg, toks[:, j], {"k": kd, "len": ld, "v": vd}, bt, live,
            block_size=bs)
        ld = c["len"]
        steps.append(lg)
    assert torch.equal(cv["len"], lens)
    assert ld.tolist() == [11, 11, 8]
    want = torch.stack(steps, 1)
    # one pass against five: the same f32 sums in other orders
    torch.testing.assert_close(lv[[0, 2]], want[[0, 2]], atol=1e-4,
                               rtol=1e-5)
    for got, ref in ((kv, kd), (vv, vd)):
        torch.testing.assert_close(got[:, :-1], ref[:, :-1], atol=1e-5,
                                   rtol=1e-5)
        untouched = [int(b) for b in bt[1]]          # slot 1's pages
        assert torch.equal(got[:, untouched], (k0 if got is kv
                                               else v0)[:, untouched])


# ---------------------------------------------------------------------------
# the engine, in lockstep with the reference's
# ---------------------------------------------------------------------------

_WEIGHTS = {}


def _weights(name):
    """(reference config, reference params, port config, port params) of
    the toy target, its 1-layer draft (separately initialised) and
    reduced mixtral."""
    if name not in _WEIGHTS:
        cfg, seed = {"toy": (toy_config(), 0),
                     "draft1": (toy_config(num_layers=1), 9),
                     "moe": (_reduced("mixtral-8x7b"), 5)}[name]
        jp, tp = _bridged(cfg, seed)
        _WEIGHTS[name] = (cfg, jp, _mirror(cfg), tp)
    return _WEIGHTS[name]


@dataclasses.dataclass
class _Side:
    """One engine: the reference (``impl="ref"``) or the port."""
    port: bool
    target: str = "toy"

    def runtime(self, sampler=GREEDY, draft=None, bs=4, sens="latency",
                **kw):
        cfg, jp, tcfg, tp = _weights(self.target)
        if draft is not None:
            dcfg, djp, dtcfg, dtp = _weights(draft)
            kw.update(draft_params=dtp if self.port else djp,
                      draft_cfg=dtcfg if self.port else dcfg)
        if self.port:
            plan = ParallelPlan(service="toy", bs=bs, category=TaskCategory(
                Sensitivity(sens), False))
            return ServiceRuntime(tcfg, tp, plan, device="cpu",
                                  sampler=S.SamplerConfig(*sampler), **kw)
        plan = JPlan(service="toy", bs=bs,
                     category=JCat(JSens(sens), False))
        return JRuntime(cfg, jp, plan, impl="ref",
                        sampler=J.SamplerConfig(*sampler), **kw)

    def req(self, rid, tokens, max_new, **kw):
        cls = GenerationRequest if self.port else JRequest
        return cls(rid=rid, tokens=np.asarray(tokens, np.int32),
                   max_new_tokens=max_new, **kw)


def _wave(vocab, seed=1, sizes=((6, 12), (9, 8), (20, 14), (3, 10),
                                (15, 9), (30, 6), (11, 11))):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, n).astype(np.int32), new)
            for n, new in sizes]


def _lockstep(jrt, trt, reqs, max_steps=400):
    """Submit ``reqs`` ((prompt, max_new[, kw])) to both runtimes and step
    them together to idle: every step's counters equal.  Returns (chains,
    the port's per-step stats)."""
    for rid, (prompt, new, *kw) in enumerate(reqs):
        kw = kw[0] if kw else {}
        jrt.submit(JRequest(rid=rid, tokens=prompt, max_new_tokens=new,
                            **kw))
        trt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                     max_new_tokens=new, **kw))
    want, got, steps = {}, {}, []
    for i in range(max_steps):
        if not (jrt.pending() or jrt.in_flight()):
            break
        js, ts = jrt.step(max_wait_s=0.0), trt.step(max_wait_s=0.0)
        for f in STEP_FIELDS:
            assert getattr(ts, f) == getattr(js, f), (i, f)
        want.update({(r.rid, r.sample): list(map(int, r.tokens))
                     for r in js.results})
        got.update({(r.rid, r.sample): list(map(int, r.tokens))
                    for r in ts.results})
        steps.append(ts)
    assert not (trt.pending() or trt.in_flight())
    assert got == want
    for name in TOTALS:
        assert getattr(trt, name) == getattr(jrt, name), name
    return got, steps


def _plain(sampler=GREEDY, **kw):
    reqs = _wave(toy_config().vocab_size)
    return _lockstep(_Side(False).runtime(sampler, **kw),
                     _Side(True).runtime(sampler, **kw), reqs)[0]


SPEC_KW = dict(max_seq_len=48, block_size=8, speculate=3)
LOCKSTEP_CASES = {"self_draft_greedy": ("toy", GREEDY),
                  "draft1_greedy": ("draft1", GREEDY),
                  "draft1_stochastic": ("draft1", STOCH)}


@pytest.mark.parametrize("case", sorted(LOCKSTEP_CASES))
def test_speculative_wave_matches_reference(case):
    """Seven requests over four slots (evictions and slot reuse, draft
    chases of 1-4 chunks): lockstep with the reference's runtime; greedy
    chains equal the plain engine's."""
    draft, sampler = LOCKSTEP_CASES[case]
    got, steps = _lockstep(
        _Side(False).runtime(sampler, draft, **SPEC_KW),
        _Side(True).runtime(sampler, draft, **SPEC_KW),
        _wave(toy_config().vocab_size))
    assert sum(s.verify_launches for s in steps) > 0
    assert sum(s.spec_slots for s in steps) > 0
    if sampler == GREEDY:
        assert got == _plain(max_seq_len=48, block_size=8)
    if draft == "toy":
        # a self-draft proposes the target's own tokens: every round of a
        # slot that does not finish in it commits k + 1
        assert sum(s.accepted_tokens for s in steps) \
            >= 2 * sum(s.verify_launches for s in steps)


def test_tail_of_generation_degrades_to_plain_decode():
    """At a 32-token budget a round that would pass the slot's table
    finishes the request with plain decode (``spec_degraded``), in step
    with the reference; greedy chains equal the plain engine's."""
    kw = dict(max_seq_len=32, block_size=8, speculate=3)
    reqs = [(p, min(new, 32 - len(p)))
            for p, new in _wave(toy_config().vocab_size, seed=4,
                                sizes=((6, 26), (12, 20), (4, 28)))]
    got, steps = _lockstep(_Side(False).runtime(GREEDY, "draft1", **kw),
                           _Side(True).runtime(GREEDY, "draft1", **kw),
                           reqs)
    assert sum(s.spec_degraded for s in steps) == 3
    plain, _ = _lockstep(_Side(False).runtime(max_seq_len=32, block_size=8),
                         _Side(True).runtime(max_seq_len=32, block_size=8),
                         reqs)
    assert got == plain


def test_moe_speculative_wave_matches_reference():
    """Reduced mixtral-8x7b (56-token budget, 8-token blocks) with a
    self-draft: lockstep with the reference, per-step drops included."""
    kw = dict(max_seq_len=56, block_size=8, speculate=3, prefix_cache=0)
    reqs = _wave(512, seed=3, sizes=((3, 6), (9, 5), (17, 8), (30, 4),
                                     (8, 7)))
    j = _Side(False, "moe").runtime(GREEDY, "moe", **kw)
    t = _Side(True, "moe").runtime(GREEDY, "moe", **kw)
    got, steps = _lockstep(j, t, reqs)
    assert sum(s.verify_launches for s in steps) > 0


def test_verify_span_copies_a_shared_tail_after_a_prefix_hit():
    """A donor indexes a 20-token template; a request on that template (a
    prefix hit) forks a sample whose first token is its EOS, so the tail
    block stays shared while the primary's first round runs: the verify
    span copies it on write.  Frequency plan, explicit k = 3, self-draft,
    temperature 0.8; in step with the reference."""
    vocab = toy_config().vocab_size
    rng = np.random.default_rng(7)
    template = rng.integers(1, vocab, 20).astype(np.int32)
    prompt = np.concatenate([template, rng.integers(1, vocab, 5).astype(
        np.int32)])
    kw = dict(max_seq_len=64, block_size=8, speculate=3, sens="frequency")

    def run(side, eos):
        rt = side.runtime(STOCH, "toy", **kw)
        copies = []
        arena_cls = type(rt._ensure_arena(rt.groups[0]))
        orig = arena_cls.ensure_writable

        def spy(arena, slot, start, n_tokens=1):
            n = orig(arena, slot, start, n_tokens)
            if n_tokens == 4:
                copies.append(n)
            return n

        rt.submit(side.req(0, template, 3))
        donor = rt.drain()
        rt.groups[0].arena.ensure_writable = spy.__get__(rt.groups[0].arena)
        rt.submit(side.req(1, prompt, 8, n_samples=2, eos_token=eos))
        out = {(r.rid, r.sample): list(map(int, r.tokens))
               for r in donor + rt.drain()}
        return rt, out, copies

    _, first, _ = run(_Side(True), None)
    eos = first[(1, 1)][0]
    assert first[(1, 0)][0] != eos
    jrt, want, jcopies = run(_Side(False), eos)
    trt, got, tcopies = run(_Side(True), eos)
    assert got == want and got[(1, 1)] == [eos]
    assert trt.prefix_hits == jrt.prefix_hits == 1
    assert tcopies == jcopies and tcopies[0] == 1
    assert trt.verify_launches == jrt.verify_launches > 0
    assert trt.prefix_cow_copies == jrt.prefix_cow_copies


def test_evacuate_leaves_the_draft_arena_empty():
    """Evacuating a runtime with speculating slots frees every draft slot,
    as the reference does; the requests served again equal a plain run."""
    kw = dict(max_seq_len=48, block_size=8, speculate=3)
    reqs = _wave(toy_config().vocab_size)
    out = {}
    for side in (_Side(False), _Side(True)):
        rt = side.runtime(GREEDY, "draft1", **kw)
        for rid, (p, new) in enumerate(reqs):
            rt.submit(side.req(rid, p, new))
        while not any(s.spec for s in rt.groups[0].slots):
            rt.step(max_wait_s=0.0)
        rt.step(max_wait_s=0.0)
        back = rt.evacuate()
        draft = rt.groups[0].draft
        assert draft.live == 0
        assert sorted(draft._free_slots) == list(range(draft.capacity))
        assert rt.in_flight() == 0 and rt.pending() == 0
        for r in sorted(back, key=lambda r: r.rid):
            rt.submit(r)
        out[side.port] = ({r.rid for r in back},
                          {r.rid: list(map(int, r.tokens))
                           for r in rt.drain()})
    assert out[True] == out[False]
    back, served = out[True]
    assert served == {rid: c for (rid, _), c in _plain(
        max_seq_len=48, block_size=8).items() if rid in back}


# ---------------------------------------------------------------------------
# tests/test_speculative.py's scenarios, on both engines
# ---------------------------------------------------------------------------

def _tokens_of(rt, reqs):
    for r in reqs:
        rt.submit(r)
    return {(r.rid, r.sample): list(map(int, r.tokens)) for r in rt.drain()}


def scenario_greedy_bit_identical(side):
    prompt = np.arange(1, 8)
    reqs = lambda: [side.req(0, prompt, 9), side.req(1, np.arange(2, 7), 7)]
    want = _tokens_of(side.runtime(), reqs())
    rt = side.runtime(draft="toy", speculate=3)
    got = _tokens_of(rt, reqs())
    assert got == want
    assert rt.verify_launches > 0
    assert rt.accepted_tokens >= 2 * rt.verify_launches
    # the reference counts one verify compile; the port compiles nothing
    assert rt.verify_traces == (0 if side.port else 1)
    return got


def scenario_stochastic_deterministic(side):
    runs = [_tokens_of(side.runtime(STOCH, "toy", speculate=2),
                       [side.req(4, np.arange(1, 8), 8)]) for _ in range(2)]
    assert runs[0] == runs[1]
    return runs[0]


def scenario_category_gating(side):
    cls = ParallelPlan if side.port else JPlan
    cat = TaskCategory if side.port else JCat
    sens = Sensitivity if side.port else JSens
    lat = cls(service="s", category=cat(sens.LATENCY, False), bs=2)
    frq = cls(service="s", category=cat(sens.FREQUENCY, False), bs=2)
    assert lat.resolved_speculate(True) > 0
    assert lat.resolved_speculate(False) == 0
    assert frq.resolved_speculate(True) == 0
    with pytest.raises(ValueError, match="draft"):
        side.runtime(speculate=3)
    rt = side.runtime(draft="toy")
    assert rt.speculate_k == lat.resolved_speculate(True)
    # no draft: the category default degrades to 0
    assert side.runtime().speculate_k == 0
    return {("k", 0): [rt.speculate_k]}


def scenario_park_degrades(side):
    prompt = np.arange(1, 8)
    want = _tokens_of(side.runtime(), [side.req(6, prompt, 8)])
    rt = side.runtime(draft="toy", speculate=3)
    rt.submit(side.req(6, prompt, 8))
    for _ in range(16):
        rt.step()
        state = rt.groups[0]
        if state.slots and state.slots[0].spec \
                and 2 <= len(state.slots[0].emitted) < 8:
            break
    state = rt.groups[0]
    assert state.slots and state.slots[0].spec
    rt._park_slot(0, state, state.slots[0], now=0.0)
    assert rt.spec_degraded == 1
    assert state.draft.live == 0
    got = {(r.rid, r.sample): list(map(int, r.tokens)) for r in rt.drain()}
    assert got == want
    return got


SCENARIOS = {"greedy_bit_identical": scenario_greedy_bit_identical,
             "stochastic_deterministic": scenario_stochastic_deterministic,
             "category_gating": scenario_category_gating,
             "park_degrades": scenario_park_degrades}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_speculative_scenario_equals_reference(scenario):
    want = SCENARIOS[scenario](_Side(False))
    assert SCENARIOS[scenario](_Side(True)) == want


GATES = {"sync": dict(mode="sync"),
         "dense_kv": dict(kvcache_impl="dense"),
         "not_native": dict(paged_native=False),
         "vocab": dict(draft_cfg=toy_config(vocab_size=96)),
         "ring_draft": dict(draft_cfg=toy_config(sliding_window=16))}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_constructor_gates_match_reference(gate):
    """The reference's gate: a draft with k > 0 needs continuous mode,
    paged KV, the paged-native step, chunked prefill, a cacheable family
    with a verify entry point and a same-family same-vocab non-ring
    draft."""
    for port in (False, True):
        kw = dict(GATES[gate])
        dcfg = kw.pop("draft_cfg", None)
        side = _Side(port)
        cfg, jp, tcfg, tp = _weights("toy")
        draft = dict(draft_params=tp if port else jp,
                     draft_cfg=(_mirror(dcfg) if port else dcfg)
                     if dcfg is not None else (tcfg if port else cfg))
        with pytest.raises(ValueError, match="speculative decoding "
                                             "requires"):
            side.runtime(speculate=2, **draft, **kw)
    with pytest.raises(ValueError, match="come together"):
        _Side(True).runtime(draft_params=_weights("toy")[3])
