"""Guards of the PyTorch port's boundaries: it imports neither JAX nor the
reference package, its entry points never fall back quietly to the CPU,
and its CUDA kernel wrappers take CUDA tensors only."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import toy_config

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax():
    mods = list(_modules())
    for mod in ("repro_torch.serving.engine", "repro_torch.launch.train",
                "repro_torch.training.train_step", "repro_torch.data.pipeline"):
        assert mod in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {name}"


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without ``device="cpu"`` every entry point wants the card; where
    there is none it raises instead of running on the CPU."""
    from repro_torch import bridge
    from repro_torch.core.allocator import ParallelPlan
    from repro_torch.core.categories import Sensitivity, TaskCategory
    from repro_torch.launch import serve, train
    from repro_torch.models import ssm, transformer
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.arena import KVArena
    from repro_torch.serving.engine import ServiceRuntime
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**{f: getattr(toy_config(), f)
                         for f in ModelConfig.__dataclass_fields__})
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ssm.init(0, dataclasses.replace(cfg, family="ssm", ssm_state=16,
                                        ssm_headdim=16))
    params = transformer.init(0, cfg, device="cpu")
    plan = ParallelPlan(service="toy",
                        category=TaskCategory(Sensitivity.LATENCY, False),
                        bs=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServiceRuntime(cfg, params, plan)
    with pytest.raises(RuntimeError, match="CUDA"):
        KVArena(cfg, transformer.init_cache, capacity=2, max_seq_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.params_from_jax({"w": np.ones((2, 2), np.float32)}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "minicpm-2b", "--reduced", "--steps", "1"])


def test_cuda_wrappers_reject_cpu_tensors():
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ssd
    before = dict(pa.launches)
    ssd_before = dict(ssd.launches)
    q = torch.zeros(2, 4, 64, dtype=torch.bfloat16)
    pages = torch.zeros(5, 32, 4, 64, dtype=torch.bfloat16)
    qp = torch.zeros(5, 32, 4, 64, dtype=torch.int8)
    sc = torch.ones(5, 32, 4)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    qc = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    calls = [
        lambda: pa.paged_decode_attention(q, pages, pages, bt, lens),
        lambda: pa.paged_decode_attention_quant(q, qp, qp, sc, sc, bt, lens),
        lambda: pa.paged_chunk_prefill_attention(qc, pages, pages, bt, lens,
                                                 lens),
        lambda: pa.paged_chunk_prefill_attention_quant(qc, qp, qp, sc, sc,
                                                       bt, lens, lens),
        lambda: ssd.ssd_scan(torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16),
                             torch.zeros(1, 8, 2), torch.zeros(2),
                             torch.zeros(1, 8, 1, 16, dtype=torch.bfloat16),
                             torch.zeros(1, 8, 1, 16, dtype=torch.bfloat16)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert pa.launches == before
    assert ssd.launches == ssd_before


def test_attention_wrappers_reject_cpu_tensors():
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    before = {**fa.launches, **fab.launches, **da.launches, **ca.launches}
    q4 = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 8, 4)
    q3 = torch.zeros(2, 4, 64, dtype=torch.bfloat16)
    cache = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(q4, q4, q4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fab.flash_attention_bwd(q4, q4, q4, q4, lse, q4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        da.decode_attention(q3, cache, cache,
                            torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ca.chunk_prefill_attention(torch.zeros(2, 8, 4, 64,
                                               dtype=torch.bfloat16),
                                   cache, cache,
                                   torch.zeros(2, dtype=torch.int32),
                                   torch.ones(2, dtype=torch.int32))
    assert {**fa.launches, **fab.launches, **da.launches,
            **ca.launches} == before


def test_flash_attention_refuses_inputs_that_require_grad():
    """(The name is the forward-only guard's, which the backward replaced.)
    Gradients flow through ``ops.flash_attention`` on the CPU, to every
    input that asks for one, through the plain backward, and equal
    autograd through the materialized attention; without a graph
    (``no_grad``) the forward runs alone and records nothing."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 16, generator=gen, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, generator=gen)
    v = torch.randn(1, 8, 2, 16, generator=gen, requires_grad=True)
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert k.grad is None
    qe, ve = (t.detach().requires_grad_(True) for t in (q, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qe, k) * 16 ** -0.5
    s = s.masked_fill(torch.ones(8, 8, dtype=torch.bool).triu(1),
                      float("-inf"))
    torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), ve).square().sum() \
        .backward()
    torch.testing.assert_close(q.grad, qe.grad)
    torch.testing.assert_close(v.grad, ve.grad)
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert torch.equal(out, ref.flash_attention_ref(q, k, v)[0])


def test_dense_family_trains_and_moe_does_not():
    """(The name predates the other families' training.)  Every family's
    training forward is its own module's ``forward_hidden``."""
    from repro_torch.models import encdec, hybrid, moe, ssm, transformer, vlm
    from repro_torch.models.registry import family_api
    for family, module in (("dense", transformer), ("moe", moe),
                           ("ssm", ssm), ("hybrid", hybrid),
                           ("audio", encdec), ("vlm", vlm)):
        assert family_api(family).forward_hidden is module.forward_hidden


@pytest.mark.parametrize("family,item", [("hybrid", "item 12")])
def test_unported_families_name_their_item(family, item):
    """(The name predates the hybrid port and its training.)  The hybrid
    family serves through its paged-native steps, with no speculative
    verify, and trains through its ``forward_hidden``: ``make_loss_fn``
    builds.  (``item`` is the ROADMAP.md item that ported it.)"""
    from repro_torch.models import hybrid
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.registry import model_api
    cfg = ModelConfig(**{f: getattr(toy_config(family=family), f)
                         for f in ModelConfig.__dataclass_fields__})
    api = model_api(cfg)
    assert api.init is hybrid.init
    assert api.decode_step_paged is hybrid.decode_step_paged
    assert api.prefill_chunk_paged is hybrid.prefill_chunk_paged
    assert api.verify_step_paged is None
    assert api.forward_hidden is hybrid.forward_hidden
    from repro_torch.training import train_step
    assert callable(train_step.make_loss_fn(cfg))


def test_moe_family_is_ported_paged_native():
    """(The name predates the dense entry points.)  The MoE family serves
    through its paged-native steps and through every dense-cache entry
    point."""
    from repro_torch.models import moe
    from repro_torch.models.registry import family_api
    api = family_api("moe")
    assert api.init is moe.init
    assert api.prefill_chunk_paged is moe.prefill_chunk_paged
    assert api.decode_step_paged is moe.decode_step_paged
    assert api.prefill is moe.prefill
    assert api.prefill_chunk is moe.prefill_chunk
    assert api.decode_step is moe.decode_step


def test_vlm_family_is_ported_paged_native():
    """The VLM family serves through the dense decoder's paged-native and
    dense-cache steps, with its own chunk and one-shot prefills (the image
    prefix rides along with the first chunk); it trains through its own
    ``forward_hidden`` (prefix and text rows)."""
    from repro_torch.models import transformer, vlm
    from repro_torch.models.registry import family_api
    api = family_api("vlm")
    assert api.init is transformer.init
    assert api.prefill_chunk_paged is vlm.prefill_chunk_paged
    assert api.decode_step_paged is transformer.decode_step_paged
    assert api.prefill is vlm.prefill
    assert api.prefill_chunk is vlm.prefill_chunk
    assert api.decode_step is transformer.decode_step
    assert api.verify_step_paged is None
    assert api.forward_hidden is vlm.forward_hidden


def test_unported_moe_entry_points_name_their_items():
    """The one-shot ``prefill`` and the dense ``prefill_chunk`` and
    ``decode_step`` run (they were ROADMAP.md Queue 1 item 11), and so does
    the paged ``verify_step_paged`` (item 4): logits (B, T, V) and the
    lengths unchanged; and so does the training forward (item 12):
    hidden states (B, L, d) and a positive aux loss."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe
    cfg = reduced(get_config("mixtral-8x7b"))
    params = moe.init(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 9))
    logits, cache = moe.prefill(params, cfg, {"tokens": tokens},
                                cache_size=16)
    assert logits.shape == (2, cfg.vocab_size)
    assert tuple(cache["k"].shape[1:3]) == (2, 16) and int(cache["len"]) == 9
    logits, cache = moe.decode_step(params, cfg, tokens[:, 0], cache)
    assert logits.shape == (2, cfg.vocab_size) and int(cache["len"]) == 10
    logits, cache = moe.prefill_chunk(
        params, cfg, {"tokens": tokens[:, :4]}, cache,
        chunk_len=torch.tensor([4, 2], dtype=torch.int32))
    assert cache["len"].tolist() == [14, 12]
    assert bool(torch.isfinite(logits).all())
    hidden, aux = moe.forward_hidden(params, cfg, {"tokens": tokens},
                                     train=True)
    assert hidden.shape == (2, 9, cfg.d_model)
    assert bool(torch.isfinite(hidden).all()) and aux.item() > 0
    pool = (cfg.num_layers, 2 * 4 + 1, 8, cfg.num_kv_heads, cfg.head_dim)
    paged = {"k": torch.zeros(pool), "v": torch.zeros(pool),
             "len": torch.tensor([3, 0], dtype=torch.int32)}
    logits, out = moe.verify_step_paged(
        params, cfg, {"tokens": tokens[:, :5]}, paged,
        torch.arange(8, dtype=torch.int32).reshape(2, 4),
        chunk_len=torch.tensor([5, 0], dtype=torch.int32), block_size=8)
    assert logits.shape == (2, 5, cfg.vocab_size)
    assert out["len"].tolist() == [3, 0]
    assert bool(torch.isfinite(logits).all())


def test_moe_budget_over_the_window_raises_naming_item_11():
    """(The name is the refusal's, which ring layouts replaced.)
    reduced(mixtral-8x7b) has a 64-token window: a larger slot budget makes
    its K/V a per-slot ring, served with one-shot prefill and the
    dense-view step.  The runtime takes it, and so does the launcher at
    its default --max-seq-len of 256 (where, as in the reference, the
    control plane places it on no server: see
    test_launcher_serves_moe_on_cpu)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServiceRuntime
    cfg = reduced(get_config("mixtral-8x7b"))
    assert cfg.sliding_window == 64
    params = moe.init(0, cfg, device="cpu")
    plan = serve.plan_for(get_config("mixtral-8x7b"))
    rt = ServiceRuntime(cfg, params, plan, max_seq_len=72, block_size=8,
                        device="cpu")
    assert rt.ring_fallback and not rt.paged_native
    assert not rt.chunked_prefill
    rt = ServiceRuntime(cfg, params, plan, max_seq_len=64, block_size=8,
                        device="cpu")
    assert rt.paged_native and not rt.ring_fallback
    assert serve.main(["--archs", "mixtral-8x7b", "--device", "cpu",
                       "--requests", "1", "--max-new-tokens", "2"]) == 0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "grok-1-314b"])
def test_launcher_serves_moe_on_cpu(arch, capsys):
    """The launcher routes through the control plane, as the reference's
    does: the MoE plans need 16 and 64 GPUs, more than a server's 4, so
    SSSP places them on no server, every request ends with a FAILED
    verdict ("no alive host") and the run exits 0 with all of them
    accounted, printing the reference's outcomes.  The MoE serving path
    itself is held to the reference in tests/test_torch_moe.py."""
    from repro_torch.launch import serve
    rc = serve.main(["--archs", arch, "--device", "cpu", "--max-seq-len",
                     "64", "--requests", "4", "--max-new-tokens", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "placements: []" in out
    assert ("served 0/4 requests" in out and "outcomes={'resource_"
            "insufficiency': 4, 'failed': 4}" in out)
    assert "0 offload/timeout retries, 4 final rejects" in out


def test_launcher_refuses_weights_over_the_card_memory(monkeypatch):
    """On the card, before allocating anything, an arch whose full bf16
    weights exceed the card's memory raises: mixtral-8x7b's 93.4 GB and
    grok-1-314b's 633 GB on an 80 GB card."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("Props", (), {
                            "total_memory": 80 * 2 ** 30})())

    def no_model(*args, **kwargs):
        raise AssertionError("weights allocated before the memory check")

    monkeypatch.setattr(serve, "model_api", no_model)
    for arch, gb in (("mixtral-8x7b", "93.4"), ("grok-1-314b", "633.")):
        with pytest.raises(RuntimeError,
                           match=rf"^{arch}'s bf16 weights \({gb}") as e:
            serve.main(["--archs", arch])
        assert ("16 of its 32 layers" in str(e.value)) == (
            arch == "mixtral-8x7b")


def test_encdec_init_refuses_cpu_fallback(monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import encdec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        encdec.init(0, reduced(get_config("whisper-large-v3")))


def test_chip_smoke_refuses_to_run_without_the_card(tmp_path):
    """In a directory that holds nothing else of the repository, and (on a
    machine without a card) in the repository itself, the script fails and
    prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cases = [(alone, tmp_path)]
    if not torch.cuda.is_available():
        cases.append((ROOT / "chip_smoke.py", ROOT))
    for script, cwd in cases:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
