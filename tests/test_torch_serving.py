"""Serving-slice parity between the PyTorch port and the JAX reference.

The same request wave goes through the reference ``ServiceRuntime`` (CPU,
``impl="ref"``, prefix cache off) and the port's, on the float32 toy
config with the reference's weights carried over by the bridge.  Greedy
tokens must be identical for native-precision KV, and for int8 KV on these
fixed seeds (int8 logits agree with the reference to the tolerance that
``test_torch_model.py`` states; a rounding-boundary flip that changed a
greedy token would show here).  The host-side counters must be equal too.
"""
import dataclasses

import jax
import numpy as np
import pytest

from conftest import toy_config
from repro.core.allocator import ParallelPlan as JPlan
from repro.core.categories import Sensitivity as JSens
from repro.core.categories import TaskCategory as JCat
from repro.models import transformer as jtransformer
from repro.models.registry import model_api as jmodel_api
from repro.serving.arena import KVArena as JArena
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro_torch import bridge
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving.arena import KVArena
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_arena_bookkeeping_matches_reference(kv_dtype):
    cfg = toy_config()
    kw = dict(capacity=4, max_seq_len=40, block_size=8, kv_dtype=kv_dtype)
    ja = JArena(cfg, jtransformer.init_cache, **kw)
    ta = KVArena(_mirror(cfg), transformer.init_cache, device="cpu", **kw)
    assert ta.token_bytes == ja.token_bytes
    for jp, tp in zip(ja.pages, ta.pages):
        assert tuple(tp.shape) == tuple(jp.shape)
        if kv_dtype == "int8":
            assert tuple(tp.scales.shape) == tuple(jp.scales.shape)

    def same():
        np.testing.assert_array_equal(ta.block_tables(), ja.block_tables())
        np.testing.assert_array_equal(ta.occupancy(), ja.occupancy())
        assert ta._free_blocks == ja._free_blocks
        assert ta._free_slots == ja._free_slots
        assert ta.live == ja.live
        np.testing.assert_array_equal(ta.lens.numpy(), np.asarray(ja.lens))

    for op, arg in (("alloc", 20), ("alloc", 9), ("alloc", 33),
                    ("free", 1), ("alloc", 5), ("set_len", (2, 7)),
                    ("free", 0), ("alloc", 40), ("reset_len", 2),
                    ("free", 2), ("alloc", 17)):
        if op == "alloc":
            assert ta.can_alloc(arg) == ja.can_alloc(arg)
            if ja.can_alloc(arg):
                assert ta.alloc(arg) == ja.alloc(arg)
        elif op == "set_len":
            ta.set_len(*arg)
            ja.set_len(*arg)
        else:
            getattr(ta, op)(arg)
            getattr(ja, op)(arg)
        same()
    assert ta.chunk_bytes(5) == ja.chunk_bytes(5)
    with pytest.raises(ValueError, match="slot budget"):
        ta.alloc(41)


WAVE = [(3, 6), (9, 5), (17, 8), (30, 4), (8, 7), (25, 6), (12, 5)]


def _serve(runtime, request_cls, prompts):
    for rid, (prompt, new) in enumerate(prompts):
        runtime.submit(request_cls(rid=rid, tokens=prompt,
                                   max_new_tokens=new, stream=rid))
    return {r.rid: np.asarray(r.tokens) for r in runtime.drain()}


@pytest.mark.parametrize("sens,kv_dtype", [
    ("latency", "bf16"), ("latency", "int8"), ("frequency", "int8")])
def test_request_wave_matches_reference(sens, kv_dtype):
    """7 requests over 4 slots (eviction and re-admission), prompts that
    cross chunk buckets and page boundaries; FIFO BS composer for latency,
    MF composer (mf=2) for frequency."""
    cfg = toy_config()
    params = jmodel_api(cfg).init(jax.random.PRNGKey(7), cfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                     _mirror(cfg), "cpu")
    mf = 2 if sens == "frequency" else 1
    jplan = JPlan(service="toy", category=JCat(JSens(sens), False), bs=4,
                  mf=mf, kv_dtype=kv_dtype)
    tplan = ParallelPlan(service="toy",
                         category=TaskCategory(Sensitivity(sens), False),
                         bs=4, mf=mf, kv_dtype=kv_dtype)
    rng = np.random.default_rng(8)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), new)
               for n, new in WAVE]
    kw = dict(max_seq_len=48, block_size=8)
    jrt = JRuntime(cfg, params, jplan, impl="ref", prefix_cache=0, **kw)
    trt = ServiceRuntime(_mirror(cfg), tparams, tplan, device="cpu",
                         prefix_cache=0, **kw)
    want = _serve(jrt, JRequest, prompts)
    got = _serve(trt, GenerationRequest, prompts)
    assert sorted(got) == sorted(want) == list(range(len(WAVE)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    for name in ("decode_steps", "prefill_chunk_calls",
                 "prefill_tokens_computed", "chunk_write_bytes"):
        assert getattr(trt, name) == getattr(jrt, name), name
    assert trt.chunk_buckets == jrt.chunk_buckets
    assert trt.kv_dtype == jrt.kv_dtype == kv_dtype


def test_runtime_rejects_unported_options():
    cfg = _mirror(toy_config())
    params = transformer.init(0, cfg, device="cpu")
    plan = ParallelPlan(service="toy",
                        category=TaskCategory(Sensitivity.LATENCY, False),
                        bs=2)
    for kw in (dict(admission_policy="sdf"), dict(speculate=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ServiceRuntime(cfg, params, plan, device="cpu", **kw)
    # the radix prefix cache is ported (ROADMAP.md Queue 1 item 2): an
    # explicit retention builds a runtime with the cache on
    rt = ServiceRuntime(cfg, params, plan, device="cpu", prefix_cache=16)
    assert rt.prefix_cache_enabled and rt._prefix_knob == 16
    # the sync, dense and one-shot paths are ported (ROADMAP.md Queue 1
    # item 11); their invalid combinations raise as in the reference
    for kw in (dict(mode="sync"), dict(kvcache_impl="dense"),
               dict(chunked_prefill=False), dict(paged_native=False)):
        ServiceRuntime(cfg, params, plan, device="cpu", **kw)
    for kw in (dict(mode="batch"), dict(kvcache_impl="ring"),
               dict(mode="sync", chunked_prefill=True),
               dict(kvcache_impl="dense", paged_native=True)):
        with pytest.raises(ValueError):
            ServiceRuntime(cfg, params, plan, device="cpu", **kw)
    rt = ServiceRuntime(cfg, params, plan, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        rt.submit(GenerationRequest(rid=0, tokens=np.ones(3, np.int32),
                                    n_samples=2))


@pytest.mark.parametrize("kv", ["auto", "bf16"])
def test_launcher_serves_on_cpu(kv, capsys):
    rc = serve.main(["--device", "cpu", "--requests", "3",
                     "--max-new-tokens", "3", "--max-seq-len", "32",
                     "--kv-dtype", kv])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out
    assert ("kv=int8" if kv == "auto" else "kv=bf16") in out


def test_launcher_names_roadmap_item_for_unported_flags(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", "--servers", "3"])
    assert e.value.code == 2
    assert "ROADMAP.md Queue 1 item 6" in capsys.readouterr().err
