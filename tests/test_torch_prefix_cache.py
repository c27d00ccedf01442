"""Arena block sharing and the radix prefix cache: the PyTorch port against
the JAX reference.

* The arena: a seeded random sequence of shared allocations, frees,
  registrations, parks, copy-on-writes and retention-driven reclaims runs
  on the reference's ``KVArena`` and on the port's, whose pools start with
  the same random contents.  After every operation the block tables,
  refcounts, free lists, idle LRU, counters, evicted blocks and page
  contents (an int8 pool's scales with its values) are identical.
* The engine: each scenario of ``tests/test_prefix_cache.py`` runs on the
  reference's ``ServiceRuntime`` (``impl="ref"``, the cache on) and on the
  port's, both paged-native or both dense-view, in bf16 (the toy config's
  float32) and int8 KV; greedy tokens, every step's counters, the prompt
  tokens computed and the admission copy bytes are equal, so are the
  arenas' pools, and the port's tokens equal its own cache-off run's.
  Reduced mixtral-8x7b runs them at a 56-token budget (ROADMAP.md Queue 3:
  at 64, its window, the reference's arena takes the K/V for per-slot
  state).
* The knob: the gate raises where the reference's does, the copy of
  ``serving/prefix_cache.py`` (like the other modules the port copies)
  diffs clean against the reference, and the CPU launcher takes
  ``--prefix-cache``.
"""
import dataclasses
from pathlib import Path

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
from repro.kernels.quant import QuantPages as JQuantPages
from repro.models import transformer as jtransformer
from repro.models.registry import model_api as jmodel_api
from repro.serving.arena import KVArena as JArena
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro_torch import bridge
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.kernels.quant import QuantPages
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_api
from repro_torch.serving.arena import KVArena
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_CFG = toy_config(num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
                  head_dim=16, d_ff=64)


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# the arena
# ---------------------------------------------------------------------------

def _seed_pools(ta, rng):
    """Random contents in the port arena's pools; returns the reference
    arena's ``pages`` holding the same."""
    jpages = []
    for tp in ta.pages:
        if isinstance(tp, QuantPages):
            v = rng.integers(-127, 128, tp.values.shape).astype(np.int8)
            s = rng.random(tp.scales.shape).astype(np.float32)
            tp.values.copy_(torch.from_numpy(v))
            tp.scales.copy_(torch.from_numpy(s))
            jpages.append(JQuantPages(jnp.asarray(v), jnp.asarray(s)))
        else:
            x = rng.standard_normal(tuple(tp.shape)).astype(np.float32)
            tp.copy_(torch.from_numpy(x))
            jpages.append(jnp.asarray(x))
    return jpages


def _assert_same_arena(ja, ta, jlog, tlog):
    np.testing.assert_array_equal(ta.block_tables(), ja.block_tables())
    np.testing.assert_array_equal(ta._block_refs, ja._block_refs)
    np.testing.assert_array_equal(ta.occupancy(), ja.occupancy())
    assert ta._free_blocks == ja._free_blocks
    assert ta._free_slots == ja._free_slots
    assert list(ta._idle_cached) == list(ja._idle_cached)
    assert ta._cached == ja._cached
    assert ta._slot_blocks == ja._slot_blocks
    assert ta.free_capacity == ja.free_capacity
    for name in ("cached_evictions", "cow_copies", "cow_calls", "parks",
                 "parked_blocks", "cache_retention", "parkable"):
        assert getattr(ta, name) == getattr(ja, name), name
    assert tlog == jlog
    for jp, tp in zip(ja.pages, ta.pages):
        if isinstance(tp, QuantPages):
            np.testing.assert_array_equal(tp.values.numpy(),
                                          np.asarray(jp.values))
            np.testing.assert_array_equal(tp.scales.numpy(),
                                          np.asarray(jp.scales))
        else:
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _same_outcome(fn_j, fn_t):
    """Both calls return the same value or raise the same error type."""
    try:
        want = fn_j()
    except (RuntimeError, ValueError) as e:
        with pytest.raises(type(e)):
            fn_t()
        return None
    got = fn_t()
    assert got == want
    return got


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arena_sharing_matches_reference(seed, kv_dtype):
    kw = dict(capacity=4, max_seq_len=32, block_size=8, kv_dtype=kv_dtype)
    ja = JArena(_CFG, jtransformer.init_cache, **kw)
    ta = KVArena(_mirror(_CFG), transformer.init_cache, device="cpu", **kw)
    ja.pages = _seed_pools(ta, np.random.default_rng(seed + 100))
    rng = np.random.default_rng(seed)       # the same operations either way
    jlog, tlog = [], []
    ja.evict_hook, ta.evict_hook = jlog.append, tlog.append
    ja.cache_retention = ta.cache_retention = int(rng.integers(1, 3))
    parked = []
    ops = ("alloc", "alloc", "free", "register", "register", "unregister",
           "park", "release_parked", "cow_blocks", "ensure_writable")
    for _ in range(200):
        op = ops[int(rng.integers(len(ops)))]
        live = [int(s) for s in np.flatnonzero(ja.occupancy())]
        if op == "alloc":
            total = int(rng.integers(1, 33))
            # resident blocks a prefix hit could stitch in: held by a live
            # slot or idle on the LRU
            resident = [b for b in range(ja.pool_blocks)
                        if ja.block_ref(b) > 0 or b in ja._idle_cached]
            k = int(rng.integers(0, min(len(resident),
                                        ja.blocks_for(total)) + 1))
            shared = [int(b) for b in rng.permutation(resident)[:k]]
            reserve = int(rng.integers(0, 2))
            ok = ja.can_alloc(total, shared=shared, reserve=reserve)
            assert ta.can_alloc(total, shared=shared, reserve=reserve) == ok
            if ok:
                _same_outcome(lambda: ja.alloc(total, shared=shared),
                              lambda: ta.alloc(total, shared=shared))
        elif op == "free" and live:
            slot = int(rng.choice(live))
            ja.free(slot)
            ta.free(slot)
        elif op == "register" and live:
            blocks = ja._slot_blocks[int(rng.choice(live))]
            b = int(rng.choice(blocks))
            ja.register(b)
            ta.register(b)
        elif op == "unregister" and ja._cached:
            b = int(rng.choice(sorted(ja._cached)))
            ja.unregister(b)
            ta.unregister(b)
        elif op == "park" and live:
            slot = int(rng.choice(live))
            parked.append(_same_outcome(lambda: ja.park(slot),
                                        lambda: ta.park(slot)))
        elif op == "release_parked" and parked:
            blocks = parked.pop(int(rng.integers(len(parked))))
            ja.release_parked(blocks)
            ta.release_parked(blocks)
        elif op == "cow_blocks" and live:
            pairs = []
            k = int(rng.integers(1, min(3, len(live)) + 1))
            for slot in rng.choice(live, k, replace=False):
                n = len(ja._slot_blocks[int(slot)])
                pairs.append((int(slot), int(rng.integers(n))))
            _same_outcome(lambda: ja.cow_blocks(pairs),
                          lambda: ta.cow_blocks(pairs))
        elif op == "ensure_writable" and live:
            slot = int(rng.choice(live))
            start = int(rng.integers(0, 32))
            n = int(rng.integers(1, 12))
            _same_outcome(lambda: ja.ensure_writable(slot, start, n),
                          lambda: ta.ensure_writable(slot, start, n))
        _assert_same_arena(ja, ta, jlog, tlog)
    for b in range(ja.pool_blocks):
        assert ta.block_ref(b) == ja.block_ref(b)
        assert ta.is_cached(b) == ja.is_cached(b)
    assert ja.cow_copies > 0 and ja.cached_evictions > 0 and ja.parks > 0


def test_cow_copies_values_and_scales_exactly():
    """A shared int8 block copied on write: the copy's values and scales
    equal the source's bit for bit, and the source is unchanged."""
    ta = KVArena(_mirror(_CFG), transformer.init_cache, capacity=2,
                 max_seq_len=16, block_size=8, kv_dtype="int8", device="cpu")
    _seed_pools(ta, np.random.default_rng(0))
    before = [(p.values.clone(), p.scales.clone()) for p in ta.pages]
    a = ta.alloc(16)
    b = ta.alloc(16, shared=ta._slot_blocks[a][:1])
    assert ta.cow_block(b, 0) and not ta.cow_block(b, 0)
    src, dst = ta._slot_blocks[a][0], ta._slot_blocks[b][0]
    assert src != dst
    for p, (v, s) in zip(ta.pages, before):
        assert torch.equal(p.values[:, dst], p.values[:, src])
        assert torch.equal(p.scales[:, dst], p.scales[:, src])
        assert torch.equal(p.values[:, src], v[:, src])
        assert torch.equal(p.scales[:, src], s[:, src])


# ---------------------------------------------------------------------------
# the engine: tests/test_prefix_cache.py's scenarios on both sides
# ---------------------------------------------------------------------------

_REF_PARAMS = {}


def _family(name):
    """(reference cfg, reference params, port cfg, port params)."""
    if name not in _REF_PARAMS:
        if name == "dense":
            cfg = _CFG
            jp = jtransformer.init(jax.random.PRNGKey(7), cfg)
        else:
            cfg = dataclasses.replace(
                jconfigs.reduced(jconfigs.get_config("mixtral-8x7b")),
                dtype="float32", param_dtype="float32")
            jp = jmodel_api(cfg).init(jax.random.PRNGKey(5), cfg)
        tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                    _mirror(cfg), "cpu")
        _REF_PARAMS[name] = (cfg, jp, _mirror(cfg), tp)
    return _REF_PARAMS[name]


@dataclasses.dataclass
class _Side:
    """One engine: the reference (``impl="ref"``) or the port, with the
    arch, KV precision, step path, and for mixtral the slot budget and the
    retention that stands in for the category's default."""
    port: bool
    family: str
    kv_dtype: str
    native: bool = True
    budget: int = 0
    retention: int = 0

    def runtime(self, *, bs=2, max_seq_len=64, **kw):
        cfg, jp, tcfg, tp = _family(self.family)
        cat = (Sensitivity, TaskCategory) if self.port else (JSens, JCat)
        plan_cls = ParallelPlan if self.port else JPlan
        plan = plan_cls(service="t", category=cat[1](cat[0].LATENCY, False),
                        bs=bs, kv_dtype=self.kv_dtype)
        kw.update(max_seq_len=self.budget or max_seq_len, block_size=8)
        if kw.get("prefix_cache") is None and self.retention:
            kw["prefix_cache"] = self.retention
        if self.port:
            return ServiceRuntime(tcfg, tp, plan, device="cpu",
                                  paged_native=self.native, **kw)
        return JRuntime(cfg, jp, plan, impl="ref", paged_native=self.native,
                        **kw)

    def req(self, rid, tokens, max_new):
        cls = GenerationRequest if self.port else JRequest
        return cls(rid=rid, tokens=np.asarray(tokens, np.int32),
                   max_new_tokens=max_new)

    @property
    def vocab(self):
        return _family(self.family)[0].vocab_size


STEP_FIELDS = ("admitted", "evicted", "in_flight", "pending",
               "admission_copy_bytes", "chunk_write_bytes", "decode_steps",
               "prefill_chunk_tokens", "oneshot_prefills", "prefix_lookups",
               "prefix_hits", "prefix_hit_tokens", "prefix_evicted_blocks",
               "prefix_cow_blocks")
RUN_FIELDS = ("decode_steps", "prefill_chunk_calls",
              "prefill_tokens_computed", "admission_copy_bytes",
              "chunk_write_bytes", "prefix_hits", "prefix_hit_tokens",
              "prefix_evictions", "prefix_cow_copies", "_prefix_hit_ewma",
              "prefix_cache_enabled")


def _pools(rt):
    """Each page pool of the runtime's arena without its trash block, as
    numpy: (float rows, per-row scales or None)."""
    out = []
    for p in rt.groups[0].arena.pages:
        if hasattr(p, "scales"):
            v, sc = (np.asarray(t)[:, :-1] for t in (p.values, p.scales))
            out.append((v.astype(np.float32) * sc[..., None], sc))
        else:
            out.append((np.asarray(p)[:, :-1], None))
    return out


def _assert_pools_close(got, want):
    """Every block of the port's pools holds the reference's rows: to
    float32 fuzz, or for int8 pools to one quantization step (an int8
    value can round the other way where the f32 row differs by fuzz)."""
    for (g, gs), (w, ws) in zip(got, want):
        if ws is None:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        else:
            step = np.maximum(gs, ws)[..., None] * 1.01 + 1e-6
            assert (np.abs(g - w) <= step).all()


class _Run:
    """A scenario's record on one runtime: each step's counters, the
    tokens by rid, the runtime's totals and its arena's pools."""

    def __init__(self):
        self.steps, self.tokens, self.totals, self.pools = [], {}, {}, []

    def step(self, rt, **kw):
        st = rt.step(**kw)
        self.steps.append(tuple(getattr(st, f) for f in STEP_FIELDS))
        self.tokens.update({r.rid: tuple(int(t) for t in r.tokens)
                            for r in st.results})
        return st

    def drain(self, rt):
        for _ in range(400):
            if not (rt.pending() or rt.in_flight()):
                return
            self.step(rt, max_wait_s=0.0)
        raise AssertionError("the runtime did not drain")

    def serve(self, rt, reqs):
        for r in reqs:
            rt.submit(r)
        self.drain(rt)

    def close(self, rt):
        self.totals = {f: getattr(rt, f) for f in RUN_FIELDS}
        self.pools = _pools(rt)
        return self


def _shared_prefix_reqs(side, rng, prefix, n, rid0=0, tail=6, max_new=3):
    return [side.req(rid0 + i, np.concatenate(
        [prefix, rng.integers(1, side.vocab, tail)]), max_new)
        for i in range(n)]


def scenario_repeated_prefix(side, knob):
    """test_prefix_cache.py:258: a warm request, then four sharing its
    24-token prefix."""
    prefix = np.random.default_rng(3).integers(1, side.vocab, 24)
    rt = side.runtime(prefix_cache=knob)
    run, r = _Run(), np.random.default_rng(5)
    run.serve(rt, _shared_prefix_reqs(side, r, prefix, 1))
    run.serve(rt, _shared_prefix_reqs(side, r, prefix, 4, rid0=1))
    if knob != 0:
        assert rt.prefix_hits >= 3 and rt.prefix_hit_tokens >= 3 * 24
    else:
        assert rt.prefill_tokens_computed == 5 * (24 + 6)
    return run.close(rt)


def scenario_step_counters(side, knob):
    """test_prefix_cache.py:282: one hit reported by the step that admits
    it."""
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, side.vocab, 16)
    rt = side.runtime(prefix_cache=knob)
    run = _Run()
    run.serve(rt, _shared_prefix_reqs(side, rng, prefix, 1))
    rt.submit(_shared_prefix_reqs(side, rng, prefix, 1, rid0=1)[0])
    st = run.step(rt)
    if knob != 0:
        assert (st.prefix_lookups, st.prefix_hits) == (1, 1)
        assert st.prefix_hit_tokens >= 16 and st.admitted == 1
    run.drain(rt)
    return run.close(rt)


def scenario_partial_tail(side, knob):
    """test_prefix_cache.py:298: prompts that diverge mid-block share the
    partial tail block and copy it on their first write."""
    base = np.random.default_rng(9).integers(1, side.vocab, 20)
    rt = side.runtime(prefix_cache=knob)
    run = _Run()
    run.serve(rt, [side.req(0, base, 3)])
    run.serve(rt, [side.req(1, np.concatenate([base[:18], [88, 87]]), 3),
                   side.req(2, base.copy(), 3)])
    if knob != 0:
        assert rt.prefix_cow_copies >= 1
    return run.close(rt)


def scenario_tight_pool(side, knob):
    """test_prefix_cache.py:323: with no room for the divergence copy a
    partial-tail hit falls back to its full blocks."""
    knob = 6 if knob is None else knob       # retention = the pool
    rng = np.random.default_rng(2)
    base = rng.integers(1, side.vocab, 20)
    blocker = rng.integers(1, side.vocab, 16)
    member = np.concatenate([base[:19], [90]])
    rt = side.runtime(max_seq_len=48, pool_blocks=6, prefix_cache=knob)
    run = _Run()
    run.serve(rt, [side.req(0, base, 2)])
    rt.submit(side.req(1, blocker, 6))
    run.step(rt)
    run.step(rt)
    rt.submit(side.req(2, member, 2))
    st = run.step(rt)
    run.drain(rt)
    assert len(run.tokens) == 3 and st.admitted == 1
    if knob != 0:
        # degraded: the two full blocks only, so no divergence copy
        assert (st.prefix_hit_tokens, st.prefix_cow_blocks) == (16, 0)
    return run.close(rt)


def scenario_random(seed):
    """test_prefix_cache.py:378: a random schedule over two templates that
    diverge mid-block, under a retention bound that evicts mid-flight."""
    def scenario(side, knob):
        rng = np.random.default_rng(seed)
        bases = [rng.integers(1, side.vocab, 24) for _ in range(2)]
        reqs = []
        for i in range(6):
            base = bases[int(rng.integers(0, 2))]
            cut = int(rng.integers(4, 25))
            tail = rng.integers(1, side.vocab, int(rng.integers(0, 6)))
            reqs.append((np.concatenate([base[:cut], tail]),
                         int(rng.integers(1, 5))))
        bs, retention = int(rng.integers(1, 4)), int(rng.integers(1, 7))
        rt = side.runtime(bs=bs, max_seq_len=48,
                          prefix_cache=retention if knob is None else knob)
        run = _Run()
        for i, (p, n) in enumerate(reqs[:3]):
            rt.submit(side.req(i, p, n))
        run.step(rt)
        run.step(rt)
        for i, (p, n) in enumerate(reqs[3:], start=3):
            rt.submit(side.req(i, p, n))
        run.drain(rt)
        return run.close(rt)
    return scenario


SCENARIOS = {"repeated_prefix": scenario_repeated_prefix,
             "step_counters": scenario_step_counters,
             "partial_tail": scenario_partial_tail,
             "tight_pool": scenario_tight_pool,
             **{f"random{s}": scenario_random(s) for s in (0, 1, 4)}}
_REF_RUNS = {}


# reduced mixtral at a 56-token budget: two slots make a pool of 14
# blocks, and the latency category's quarter of it (3) is less than one
# 30-token prompt's 4 blocks, so the warm prompt's chain would be reclaimed
# at its own eviction; those cases retain the whole pool
MOE = dict(budget=56, retention=14)


def _reference_run(name, family, kv_dtype, native):
    key = (name, family, kv_dtype, native)
    if key not in _REF_RUNS:
        _REF_RUNS[key] = SCENARIOS[name](
            _Side(False, family, kv_dtype, native=native,
                  **(MOE if family == "moe" else {})), None)
    return _REF_RUNS[key]


ENGINE_CASES = ([("dense", s) for s in SCENARIOS]
                + [("moe", s) for s in ("repeated_prefix", "partial_tail",
                                        "random0")])


@pytest.mark.parametrize("path", ["native", "dense_view"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("family,scenario", ENGINE_CASES,
                         ids=[f"{f}-{s}" for f, s in ENGINE_CASES])
def test_engine_scenario_matches_reference(family, scenario, kv_dtype,
                                           path):
    want = _reference_run(scenario, family, kv_dtype, path == "native")
    side = _Side(True, family, kv_dtype, native=path == "native",
                 **(MOE if family == "moe" else {}))
    got = SCENARIOS[scenario](side, None)
    assert got.tokens == want.tokens
    assert got.steps == want.steps
    assert got.totals == want.totals
    assert got.totals["prefix_cache_enabled"]
    # a write into a shared block that skipped its copy would leave the
    # sharers' tokens alone on these sizes, but not the blocks' rows
    _assert_pools_close(got.pools, want.pools)
    off = SCENARIOS[scenario](side, 0)
    assert off.tokens == got.tokens
    assert not off.totals["prefix_cache_enabled"]
    assert off.totals["prefix_hits"] == 0


def test_queue_time_estimate_discounts_cached_tokens():
    """test_prefix_cache.py:356, with the reference's figures."""
    est = []
    for port in (False, True):
        rt = _Side(port, "dense", "bf16").runtime(bs=1)
        assert rt.prefix_cache_enabled
        rt._service_ewma_s = 1.0
        rt.submit(_Side(port, "dense", "bf16").req(
            0, np.arange(1, 50), 1))
        cold = rt.queue_time_estimate()
        rt._prefix_hit_ewma = 0.9
        est.append((cold, rt.queue_time_estimate()))
    assert est[1] == est[0]
    cold, warm = est[1]
    assert 0.0 < warm < cold


# ---------------------------------------------------------------------------
# the knob, the copied modules and the launcher
# ---------------------------------------------------------------------------

def _reduced(arch):
    return dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                               dtype="float32", param_dtype="float32")


GATE_CASES = {"sync": ("dense", dict(mode="sync")),
              "dense": ("dense", dict(kvcache_impl="dense")),
              "oneshot": ("dense", dict(chunked_prefill=False)),
              "ssm": ("mamba2-2.7b", {}),
              "audio": ("whisper-large-v3", {}),
              "ring": ("mixtral-8x7b", dict(max_seq_len=128))}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_knob_gate_raises_where_the_reference_raises(case):
    """An explicit cache on a path that cannot share blocks raises a
    ValueError on both sides; the plan's category default turns it off
    there without a word, and an explicit 0 is always taken."""
    arch, kw = GATE_CASES[case]
    cfg = _CFG if arch == "dense" else _reduced(arch)
    kw = dict(dict(max_seq_len=64, block_size=8), **kw)
    jplan = JPlan(service="t", category=JCat(JSens.LATENCY, False), bs=2)
    tplan = ParallelPlan(service="t", category=TaskCategory(
        Sensitivity.LATENCY, False), bs=2)
    tcfg = _mirror(cfg)
    tp = model_api(tcfg).init(0, tcfg, "cpu")
    for knob in (-1, True, 16):
        with pytest.raises(ValueError, match="prefix_cache requires"):
            JRuntime(cfg, None, jplan, impl="ref", prefix_cache=knob, **kw)
        with pytest.raises(ValueError, match="prefix_cache requires"):
            ServiceRuntime(tcfg, tp, tplan, device="cpu", prefix_cache=knob,
                           **kw)
    for knob in (None, 0, False):
        rt = ServiceRuntime(tcfg, tp, tplan, device="cpu", prefix_cache=knob,
                            **kw)
        assert not rt.prefix_cache_enabled
    with pytest.raises(ValueError, match="prefix_cache must be"):
        ServiceRuntime(tcfg, tp, tplan, device="cpu", prefix_cache=-2, **kw)


@pytest.mark.parametrize("module", [
    "serving/prefix_cache.py", "serving/batching.py",
    "serving/admission.py", "core/allocator.py",
    "core/categories.py", "core/costmodel.py", "core/goodput.py",
    "core/handler.py", "core/sync.py", "core/placement.py",
    "core/cluster.py", "core/__init__.py", "core/faults.py",
    "serving/failover.py", "simulator/workload.py",
    "simulator/baselines.py", "simulator/engine.py", "obs/trace.py",
    "obs/metrics.py", "obs/calibrate.py", "obs/__init__.py",
    "models/sharding.py", "data/pipeline.py"])
def test_copied_module_diffs_clean_against_the_reference(module):
    port = (ROOT / "src/repro_torch" / module).read_text()
    assert port.replace("repro_torch", "repro") == (
        ROOT / "src/repro" / module).read_text()


def test_launcher_serves_with_the_category_prefix_cache(capsys):
    rc = serve.main(["--device", "cpu", "--requests", "3",
                     "--max-new-tokens", "3", "--max-seq-len", "32",
                     "--prefix-cache", "-1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out
    line = [ln for ln in out.splitlines() if ln.startswith("prefix cache:")]
    assert len(line) == 1 and "prompt tokens reused" in line[0]
    assert "18 computed" in line[0]             # three 6-token prompts


def test_launcher_refuses_a_prefix_cache_below_minus_one(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", "--prefix-cache", "-2"])
    assert e.value.code == 2
    assert "--prefix-cache must be -1" in capsys.readouterr().err
