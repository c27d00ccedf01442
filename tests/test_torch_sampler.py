"""Stochastic sampling on the port against the JAX reference.

* The PRNG: the port's threefry-2x32 in torch integer ops against
  ``jax.random`` (JAX's default ``jax_threefry_partitionable``): the
  counter-chain keys (``slot_keys``, through ``jax.random.key_data``) on
  1,200 random (seed, sample, offset) triples and every stream tag, the
  ``fold_in`` chain, ``PRNGKey``, and ``random_bits`` on shapes whose flat
  size passes 2**16, alone and one key a row (``vmap``): exactly equal.
  Uniforms are bit-identical.  The Gumbel noise takes two logarithms; the
  port's are correctly rounded and XLA's are within one unit in the last
  place (ulp) of them, so each log is held to 1 ulp and the noise to 2
  ulps at ``max(|g|, 1)`` (near its zero crossing the noise is the
  difference of two values near 1, whose ulp is what the error follows).
* The samplers: ``sample``, ``sample_per_slot`` (temperatures 0.7 and
  1.3, ``top_k`` 0, 20 and a cutoff tied three ways, live and occupancy
  masks) and ``speculative_verify`` (greedy and stochastic, k = 1-4) give
  the reference's tokens and ``n_emit`` on the same float32 logits.
* The engine: ``tests/test_speculative.py``'s sampling scenarios (batch
  composition, arrival order, park and resume, an explicit seed, sync
  against continuous) and its fork scenarios run on the reference's
  ``ServiceRuntime`` (``impl="ref"``) and the port's, on the float32 toy
  config with the reference's weights carried over by the bridge, at
  temperature 0.8 and ``top_k`` 40, on six paths: dense paged-native,
  dense view, sync, SSM (reduced mamba2-2.7b), audio (reduced
  whisper-large-v3) and MoE (reduced mixtral-8x7b).  Chains are compared
  token for token; a token that differs must be one where the
  reference's top two perturbed scores lie closer than the logit gap
  measured between the two engines at that position
  (``_explain_mismatch``), never one re-seeded away.
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
from repro.models.registry import model_api as jmodel_api
from repro.serving import sampler as J
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro_torch import bridge
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_api
from repro_torch.serving import sampler as S
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

STOCH = (0.8, 40)


def _words(a):
    return np.asarray(a).astype(np.int64)


def _jkey_words(k):
    return _words(jax.random.key_data(k))


def _tkey(k):
    return torch.from_numpy(_jkey_words(k))


# ---------------------------------------------------------------------------
# the PRNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [S.STREAM_DECODE, S.STREAM_DRAFT,
                                    S.STREAM_VERIFY, S.STREAM_CORRECTION])
def test_slot_keys_equal_jax(stream):
    rng = np.random.default_rng(stream)
    n = 1200
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    sids = rng.integers(0, 8, n).astype(np.uint32)
    offs = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    for seed in (0, 1234):
        want = _jkey_words(J.slot_keys(jax.random.PRNGKey(seed), seeds,
                                       sids, offs, stream))
        got = S.slot_keys(S.prng_key(seed), seeds, sids, offs, stream)
        np.testing.assert_array_equal(got.numpy(), want)


def test_prng_key_and_fold_in_chain_equal_jax():
    rng = np.random.default_rng(1)
    for seed in [0, 1, 7, 2 ** 31 - 1, *rng.integers(0, 2 ** 31, 20)]:
        k = jax.random.PRNGKey(int(seed))
        t = S.prng_key(int(seed))
        np.testing.assert_array_equal(t.numpy(), _jkey_words(k))
        for d in rng.integers(0, 2 ** 32, 50, dtype=np.uint64):
            k = jax.random.fold_in(k, np.uint32(d))
            t = S.fold_in(t, int(d))
            np.testing.assert_array_equal(t.numpy(), _jkey_words(k))
    # a seed wider than 32 bits is split into its high and low words, as
    # threefry_seed does with 64-bit integers enabled
    with jax.enable_x64(True):
        wide = _jkey_words(jax.random.PRNGKey(np.int64(2 ** 40 + 3)))
    np.testing.assert_array_equal(S.prng_key(2 ** 40 + 3).numpy(), wide)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 30000), (70001,),
                                   (2, 3, 11000)])
def test_random_bits_equal_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = _words(jax.random.bits(key, shape, jnp.uint32))
    got = S.random_bits(_tkey(key), shape)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_bits_one_key_a_row_equal_vmap():
    keys = J.slot_keys(jax.random.PRNGKey(0), np.arange(5), [0, 1, 2, 0, 1],
                       [9, 8, 7, 6, 5])
    V = 70001                                   # past 2**16 a row
    want = _words(jax.vmap(lambda k: jax.random.bits(k, (V,), jnp.uint32))(
        keys))
    got = S.random_bits(torch.from_numpy(_jkey_words(keys)), (V,))
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_is_bit_identical_and_gumbel_within_two_ulps():
    key = jax.random.fold_in(jax.random.PRNGKey(0), 5)
    shape = (40, 30000)
    bits = S.random_bits(_tkey(key), shape)
    for lo in (0.0, float(np.finfo(np.float32).tiny)):
        want = np.asarray(jax.random.uniform(key, shape, minval=lo,
                                             maxval=1.0))
        got = S.uniform_from_bits(bits, lo).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    u = S.uniform_from_bits(bits, float(np.finfo(np.float32).tiny)).numpy()

    def ulps(a, b):
        return np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64))

    inner = np.array(-jnp.log(u))
    assert ulps(S._neg_log(torch.from_numpy(u)).numpy(), inner).max() <= 1
    assert ulps(S._neg_log(torch.from_numpy(inner)).numpy(),
                np.asarray(-jnp.log(inner))).max() <= 1
    want = np.asarray(jax.random.gumbel(key, shape))
    got = S.gumbel_from_bits(bits).numpy()
    spacing = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 2 * spacing).all()
    assert (got == want).mean() > 0.5


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------

def _tied_logits(B, V, rng):
    """Rows whose top_k = 2 cutoff is a three-way tie (cutoff tie case)."""
    lg = rng.normal(size=(B, V)).astype(np.float32)
    lg[:, [3, 9, 14]] = 10.0
    return lg


TOPK_CASES = {"off": 0, "20": 20, "tie": 2}


@pytest.mark.parametrize("topk", sorted(TOPK_CASES))
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_sample_per_slot_equals_reference(temperature, topk):
    rng = np.random.default_rng(int(temperature * 10) + len(topk))
    B, V = 48, 300
    lg = (_tied_logits(B, V, rng) if topk == "tie"
          else 3 * rng.normal(size=(B, V)).astype(np.float32))
    seeds, sids = rng.integers(0, 1000, B), rng.integers(0, 4, B)
    offs = rng.integers(0, 64, B)
    live, occ = rng.random(B) < 0.8, rng.random(B) < 0.8
    jcfg = J.SamplerConfig(temperature, TOPK_CASES[topk])
    tcfg = S.SamplerConfig(temperature, TOPK_CASES[topk])
    for masks in ({}, dict(live=live), dict(live=live, occupancy=occ)):
        want = np.asarray(J.sample_per_slot(
            jnp.asarray(lg), jax.random.PRNGKey(0), seeds, sids, offs, jcfg,
            fill_token=5, **{k: jnp.asarray(v) for k, v in masks.items()}))
        got = S.sample_per_slot(
            torch.from_numpy(lg), S.prng_key(0), seeds, sids, offs, tcfg,
            fill_token=5,
            **{k: torch.from_numpy(v) for k, v in masks.items()}).numpy()
        np.testing.assert_array_equal(got, want)
        if topk == "tie":
            drawn = got[got != 5] if masks else got
            assert set(drawn.tolist()) <= {3, 9, 14}
            assert len(set(drawn.tolist())) == 3     # every tied entry kept
    # greedy draws no bits and still masks
    g = S.sample_per_slot(torch.from_numpy(lg), S.prng_key(0), seeds, sids,
                          offs, S.SamplerConfig(), live=torch.from_numpy(live),
                          fill_token=7).numpy()
    np.testing.assert_array_equal(g, np.where(live, np.argmax(lg, -1), 7))


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.7, 0), (1.3, 20)])
def test_sample_shared_key_equals_reference(temperature, top_k):
    rng = np.random.default_rng(4)
    lg = 2 * rng.normal(size=(6, 500)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(9), 2)
    want = np.asarray(J.sample(jnp.asarray(lg), key,
                               J.SamplerConfig(temperature, top_k)))
    got = S.sample(torch.from_numpy(lg), _tkey(key),
                   S.SamplerConfig(temperature, top_k)).numpy()
    np.testing.assert_array_equal(got, want)


def test_only_live_rows_are_drawn_with_the_same_tokens():
    """The port draws only the rows the masks keep; each row's token is
    the one its own key gives, whatever the other rows."""
    rng = np.random.default_rng(2)
    lg = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
    cfg = S.SamplerConfig(0.9, 0)
    every = S.sample_per_slot(lg, S.prng_key(0), range(8), [0] * 8,
                              range(8), cfg)
    live = torch.tensor([0, 1, 0, 0, 1, 1, 0, 1], dtype=torch.bool)
    some = S.sample_per_slot(lg, S.prng_key(0), range(8), [0] * 8,
                             range(8), cfg, live=live, fill_token=-1)
    assert torch.equal(some[live], every[live])
    assert (some[~live] == -1).all()


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_speculative_verify_equals_reference(k, temperature):
    rng = np.random.default_rng(10 * k + int(temperature * 10))
    B, V = 40, 60
    tl = rng.normal(size=(B, k + 1, V)).astype(np.float32)
    dl = (tl[:, :k] + 0.5 * rng.normal(size=(B, k, V))).astype(np.float32)
    drafts = np.argmax(dl, -1)
    flip = rng.random((B, k)) < 0.3
    drafts = np.where(flip, rng.integers(0, V, (B, k)), drafts).astype(
        np.int32)
    seeds, sids = rng.integers(0, 500, B), rng.integers(0, 3, B)
    offs = rng.integers(0, 40, B)
    live = rng.random(B) < 0.85
    jcfg, tcfg = (J.SamplerConfig(temperature, 12),
                  S.SamplerConfig(temperature, 12))
    out, n_emit = J.speculative_verify(
        jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(drafts),
        jax.random.PRNGKey(0), seeds, sids, offs, jcfg,
        live=jnp.asarray(live), fill_token=1)
    got, got_n = S.speculative_verify(
        torch.from_numpy(tl), torch.from_numpy(dl), torch.from_numpy(drafts),
        S.prng_key(0), seeds, sids, offs, tcfg, live=torch.from_numpy(live),
        fill_token=1)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(n_emit))
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))
    assert len(set(np.asarray(n_emit)[live].tolist())) > 1


def test_stream_tags_give_disjoint_keys():
    keys = [S.slot_keys(S.prng_key(0), [1], [0], [0], s).numpy()
            for s in range(4)]
    assert len({tuple(k.ravel()) for k in keys}) == 4


# ---------------------------------------------------------------------------
# the engine on six paths
# ---------------------------------------------------------------------------

def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _reduced(arch):
    return dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                               dtype="float32", param_dtype="float32")


# path -> (reference config, runtime kwargs)
PATHS = {"paged": ("dense", {}),
         "dense_view": ("dense", dict(paged_native=False)),
         "sync": ("dense", dict(mode="sync")),
         "ssm": ("mamba2-2.7b", {}),
         "audio": ("whisper-large-v3", {}),
         # reduced mixtral at a 56-token budget in 8-token blocks, below
         # its 64-token window (ROADMAP.md Queue 3, reference caveats)
         "moe": ("mixtral-8x7b", dict(max_seq_len=56, block_size=8))}
_WEIGHTS = {}


def _weights(arch):
    if arch not in _WEIGHTS:
        cfg = toy_config() if arch == "dense" else _reduced(arch)
        jp = jmodel_api(cfg).init(jax.random.PRNGKey(0), cfg)
        tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                    _mirror(cfg), "cpu")
        _WEIGHTS[arch] = (cfg, jp, _mirror(cfg), tp)
    return _WEIGHTS[arch]


@dataclasses.dataclass
class _Side:
    """One engine of a path: the reference (``impl="ref"``) or the port."""
    port: bool
    path: str
    sent: dict = dataclasses.field(default_factory=dict)   # rid ->
    #                                (prompt, seed) of its first request

    def runtime(self, sampler=STOCH, bs=4, sens="latency", **kw):
        arch, path_kw = PATHS[self.path]
        cfg, jp, tcfg, tp = _weights(arch)
        kw = dict(path_kw, **kw)
        if self.port:
            plan = ParallelPlan(service="toy", bs=bs, category=TaskCategory(
                Sensitivity(sens), False))
            return ServiceRuntime(tcfg, tp, plan, device="cpu",
                                  sampler=S.SamplerConfig(*sampler), **kw)
        plan = JPlan(service="toy", bs=bs,
                     category=JCat(JSens(sens), False))
        return JRuntime(cfg, jp, plan, impl="ref",
                        sampler=J.SamplerConfig(*sampler), **kw)

    def extras(self, tokens):
        """Audio requests carry frame embeddings drawn from their prompt."""
        cfg = _weights(PATHS[self.path][0])[0]
        if cfg.family != "audio":
            return None
        rng = np.random.default_rng(int(np.sum(tokens)))
        return {"embeddings": rng.normal(
            size=(cfg.encoder_len, cfg.d_model)).astype(np.float32)}

    def req(self, rid, tokens, max_new, **kw):
        cls = GenerationRequest if self.port else JRequest
        tokens = np.asarray(tokens, np.int32)
        kw.setdefault("extras", self.extras(tokens))
        self.sent.setdefault(rid, (tokens, kw.get("seed", rid)))
        return cls(rid=rid, tokens=tokens, max_new_tokens=max_new, **kw)


def _tokens_of(rt, reqs):
    for r in reqs:
        rt.submit(r)
    return {(r.rid, r.sample): list(map(int, r.tokens)) for r in rt.drain()}


def scenario_batch_composition(side):
    prompt = np.arange(1, 8)
    alone = _tokens_of(side.runtime(), [side.req(1, prompt, 6)])
    mixed = _tokens_of(side.runtime(), [
        side.req(1, prompt, 6), side.req(2, np.arange(3, 12), 9),
        side.req(3, np.arange(5, 9), 4)])
    assert alone[(1, 0)] == mixed[(1, 0)]
    return mixed


def scenario_arrival_order(side):
    a = (1, np.arange(1, 8), 5)
    b = (2, np.arange(2, 9), 5)
    ab = _tokens_of(side.runtime(), [side.req(*a), side.req(*b)])
    ba = _tokens_of(side.runtime(), [side.req(*b), side.req(*a)])
    assert ab == ba
    return ab


def scenario_park_resume(side):
    prompt = np.arange(1, 8)
    want = _tokens_of(side.runtime(), [side.req(5, prompt, 8)])
    rt = side.runtime()
    rt.submit(side.req(5, prompt, 8))
    for _ in range(16):
        rt.step()
        state = rt.groups[0]
        if state.slots and not state.slots[0].prefilling \
                and len(state.slots[0].emitted) >= 3:
            break
    state = rt.groups[0]
    assert state.slots and len(state.slots[0].emitted) >= 3
    rt._park_slot(0, state, state.slots[0], now=0.0)
    assert rt.admission.parked
    got = {(r.rid, r.sample): list(map(int, r.tokens)) for r in rt.drain()}
    assert got == want
    return got


def scenario_explicit_seed(side):
    prompt = np.arange(1, 8)
    r1 = _tokens_of(side.runtime(), [side.req(1, prompt, 6, seed=77)])
    r2 = _tokens_of(side.runtime(), [side.req(2, prompt, 6, seed=77)])
    r3 = _tokens_of(side.runtime(), [side.req(1, prompt, 6, seed=78)])
    assert r1[(1, 0)] == r2[(2, 0)]
    assert r1[(1, 0)] != r3[(1, 0)]
    return {**r1, **r2}


def scenario_sync_and_continuous(side):
    cont = _tokens_of(side.runtime(mode="continuous"),
                      [side.req(3, np.arange(1, 8), 5)])
    sync = _tokens_of(side.runtime(mode="sync"),
                      [side.req(3, np.arange(1, 8), 5)])
    assert cont == sync
    return cont


SCENARIOS = {"batch_composition": scenario_batch_composition,
             "arrival_order": scenario_arrival_order,
             "park_resume": scenario_park_resume,
             "explicit_seed": scenario_explicit_seed,
             "sync_and_continuous": scenario_sync_and_continuous}
# every scenario on the paged-native path; on the others the scenarios
# that path changes: parking needs a parkable arena (continuous paged, no
# per-slot state), and sync mode left-pads a batch's prompts with no mask,
# so a request's tokens there depend on its batch by design
ENGINE_CASES = ([("paged", s) for s in SCENARIOS]
                + [(p, s) for p in ("dense_view", "moe")
                   for s in ("batch_composition", "park_resume")]
                + [(p, "batch_composition") for p in ("ssm", "audio")]
                + [("audio", "explicit_seed")]
                + [("sync", s) for s in ("arrival_order",
                                         "sync_and_continuous")])


def _explain_mismatch(side_j, side_t, rid, sample, seed, prefix, prompt):
    """A token the port draws differently at position ``len(prefix)``:
    rerun the prompt and the agreed prefix through both models' one-shot
    prefill, and return (the reference's top-two perturbed-score margin,
    the measured largest logit gap between the engines there)."""
    arch, _ = PATHS[side_j.path]
    cfg, jp, tcfg, tp = _weights(arch)
    seq = np.concatenate([prompt, prefix]).astype(np.int32)[None]
    batch = {"tokens": jnp.asarray(seq)}
    tbatch = {"tokens": torch.from_numpy(seq)}
    extras = side_j.extras(prompt)
    if extras:
        emb = np.asarray(extras["embeddings"])[None]
        batch["embeddings"] = jnp.asarray(emb)
        tbatch["embeddings"] = torch.from_numpy(emb)
    jl, _ = jmodel_api(cfg).prefill(jp, cfg, batch, cache_size=seq.shape[1]
                                    + 1, impl="ref")
    tl, _ = model_api(tcfg).prefill(tp, tcfg, tbatch,
                                    cache_size=seq.shape[1] + 1)
    jl = np.asarray(jl, np.float32).reshape(-1)
    gap = float(np.abs(tl.float().numpy().reshape(-1) - jl).max())
    key = J.slot_keys(jax.random.PRNGKey(0), [seed], [sample],
                      [len(prefix)])[0]
    scores = np.asarray(jax.random.gumbel(key, jl.shape)) + np.asarray(
        J._filtered(jnp.asarray(jl), J.SamplerConfig(*STOCH)))
    top = np.sort(scores)[-2:]
    return float(top[1] - top[0]), gap / STOCH[0]


def _assert_same_chains(side, want, got):
    """Equal chains, or each first differing token explained by a near tie
    of the reference's perturbed scores."""
    assert sorted(got) == sorted(want)
    for key, chain in want.items():
        if got[key] == chain:
            continue
        pos = next((i for i, (a, b) in enumerate(zip(chain, got[key]))
                    if a != b), min(len(chain), len(got[key])))
        rid, sample = key
        prompt, seed = side.sent[rid]
        margin, gap = _explain_mismatch(_Side(False, side.path), side, rid,
                                        sample, seed,
                                        np.asarray(chain[:pos]), prompt)
        assert margin < 2 * gap, (key, pos, margin, gap)


@pytest.mark.parametrize("path,scenario", ENGINE_CASES,
                         ids=[f"{p}-{s}" for p, s in ENGINE_CASES])
def test_engine_scenario_equals_reference(path, scenario):
    want = SCENARIOS[scenario](_Side(False, path))
    side = _Side(True, path)
    _assert_same_chains(side, want, SCENARIOS[scenario](side))


def test_mismatch_explainer_reads_a_margin_and_a_gap():
    """``_explain_mismatch`` on a position where the chains agree: the
    reference's top-two margin there is wider than the engines' logit
    gap, which is why the token is the same."""
    side = _Side(False, "paged")
    prompt = np.arange(1, 8)
    chain = _tokens_of(side.runtime(), [side.req(1, prompt, 4)])[(1, 0)]
    margin, gap = _explain_mismatch(side, _Side(True, "paged"), 1, 0, 1,
                                    np.asarray(chain[:2]), prompt)
    assert 0.0 <= gap < 1e-3 and margin > 2 * gap
    _assert_same_chains(side, {(1, 0): chain}, {(1, 0): list(chain)})


# ---------------------------------------------------------------------------
# n>1 parallel sampling: test_speculative.py's fork scenarios
# ---------------------------------------------------------------------------

def scenario_fork_and_diverge(side):
    """n_samples = 3 on a frequency plan of 4 slots: three results for one
    rid, three distinct streams, the prompt prefilled once, the shared
    tail block copied on write, and a clean teardown."""
    rt = side.runtime(sens="frequency")
    res = _tokens_of(rt, [side.req(7, np.arange(1, 8), 6, n_samples=3)])
    assert sorted(s for _, s in res) == [0, 1, 2]
    assert len({tuple(v) for v in res.values()}) == 3
    assert rt.forks_spawned == 2 and rt.fork_shortfall == 0
    assert rt.prefill_tokens_computed == 7
    assert rt.prefix_cow_copies >= 2
    assert not rt._sibling_refs
    arena = rt.groups[0].arena
    assert len(arena._free_slots) == arena.capacity
    return res


def scenario_fork_batch_independent(side):
    def fan(extra):
        reqs = [side.req(7, np.arange(1, 8), 5, n_samples=3)]
        if extra:
            reqs.append(side.req(50, np.arange(4, 10), 7))
        out = _tokens_of(side.runtime(bs=4, sens="frequency"), reqs)
        return {k: v for k, v in out.items() if k[0] == 7}
    a = fan(False)
    assert a == fan(True)
    return a


def scenario_fork_shortfall(side):
    rt = side.runtime(bs=2, sens="frequency")
    res = _tokens_of(rt, [side.req(9, np.arange(1, 6), 4, n_samples=4)])
    assert len(res) == 2 and rt.forks_spawned == 1
    assert rt.fork_shortfall >= 1
    return res


FORKS = {"fork_and_diverge": scenario_fork_and_diverge,
         "fork_batch_independent": scenario_fork_batch_independent,
         "fork_shortfall": scenario_fork_shortfall}


FORK_CASES = ([("paged", s) for s in FORKS]
              + [("dense_view", "fork_and_diverge")])


@pytest.mark.parametrize("path,scenario", FORK_CASES,
                         ids=[f"{p}-{s}" for p, s in FORK_CASES])
def test_fork_scenario_equals_reference(path, scenario):
    want = FORKS[scenario](_Side(False, path))
    side = _Side(True, path)
    _assert_same_chains(side, want, FORKS[scenario](side))


def test_runtime_seed_keys_every_stream():
    """The runtime's ``seed`` is the base key: two runtimes of one seed
    draw the same chains, another seed others; the reference agrees."""
    chains = {}
    for port in (False, True):
        for seed in (0, 5):
            side = _Side(port, "paged")
            rt = side.runtime(seed=seed)
            chains[port, seed] = _tokens_of(
                rt, [side.req(1, np.arange(1, 8), 6)])
    assert chains[True, 0] == chains[False, 0]
    assert chains[True, 5] == chains[False, 5]
    assert chains[True, 0] != chains[True, 5]
