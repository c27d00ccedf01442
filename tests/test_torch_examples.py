"""The port's examples (``examples/torch_*.py``) and ``RequestStream`` on
the CPU.

* ``RequestStream``'s Poisson and Gamma arrivals equal the reference's
  for the same seeds (the port's ``data/pipeline.py`` is a verbatim copy);
* the quickstart and the §4.3 case study run with the reference
  example's own ``PRNGKey(0)`` weights carried across by
  ``bridge.params_from_jax``: their plan, placement, handler and token
  lines equal the lines the reference example prints (the reference runs
  once a example, in two subprocesses started together, each of which
  also writes its weights); wall times and the reference's decode-compile
  counts are taken out of the lines first, since the port compiles nothing
  and prints its kernel launches instead.  A token chain may split from
  the reference's only at a bf16 tie: where the two chains part, the
  reference model's logits (a one-shot prefill of the prompt and the
  tokens before the split) put the port's token within one bf16 ulp of
  the reference's top logit (``chip_smoke.py``'s ``bf16_tie`` bound), and
  the split is named in the test's output;
* serve_cluster under ``--chaos`` (with its trace and metrics files) and
  train_small at a few steps, through the port alone: every rid
  accounted for, the loss falling, the checkpoint written and read back.
"""
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.data.pipeline import RequestStream as RefRequestStream
from repro.models.registry import model_api as ref_model_api
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import RequestStream

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("burstiness", [1.0, 8.0])
@pytest.mark.parametrize("seed", [0, 3])
def test_request_stream_arrivals_equal_the_reference(seed, burstiness):
    kw = dict(rate=50.0, horizon_s=20.0, seed=seed, burstiness=burstiness)
    got = RequestStream(**kw).arrival_times()
    assert np.array_equal(got, RefRequestStream(**kw).arrival_times())
    assert 400 < len(got) < 1600 and got.max() < 20.0
    if burstiness > 1.0:
        cv2 = lambda a: float(np.var(np.diff(a)) / np.mean(np.diff(a)) ** 2)
        plain = RequestStream(**{**kw, "burstiness": 1.0}).arrival_times()
        assert cv2(got) > cv2(plain)


# runs a reference example as a user would (its ``__main__``), keeps what
# it prints, and writes the reduced config's PRNGKey(0) weights it served
# with (float32 values beside each leaf's dtype: bf16 survives exactly)
REF_SCRIPT = r"""
import contextlib, io, json, runpy, sys
import jax
import numpy as np
from repro.configs import get_config, reduced
from repro.models.registry import model_api

path, arch, out = sys.argv[1:4]
sys.argv = [path]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    runpy.run_path(path, run_name="__main__")
cfg = reduced(get_config(arch))
params = model_api(cfg).init(jax.random.PRNGKey(0), cfg)
flat = {"/".join(str(k.key) for k in p): leaf for p, leaf
        in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(out, stdout=buf.getvalue(),
         dtypes=json.dumps({k: str(v.dtype) for k, v in flat.items()}),
         **{"p/" + k: np.asarray(v, np.float32) for k, v in flat.items()})
"""

REFERENCE_EXAMPLES = {"quickstart": "minicpm-2b",
                      "llm_case_study": "codeqwen1.5-7b"}


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Each reference example's printed lines and its weights bridged to
    the port, the two runs started together."""
    tmp = tmp_path_factory.mktemp("ref_examples")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    runs = {name: subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT,
         str(ROOT / "examples" / f"{name}.py"), arch,
         str(tmp / f"{name}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, arch in REFERENCE_EXAMPLES.items()}
    out = {}
    for name, run in runs.items():
        _, err = run.communicate(timeout=300)
        assert run.returncode == 0, err[-3000:]
        z = np.load(tmp / f"{name}.npz")
        dtypes = json.loads(str(z["dtypes"]))
        flat = {k[2:]: z[k].astype(ml_dtypes.bfloat16)
                if dtypes[k[2:]] == "bfloat16" else z[k]
                for k in z.files if k.startswith("p/")}
        cfg = reduced(get_config(REFERENCE_EXAMPLES[name]))
        tree = _unflatten(flat)
        out[name] = dict(lines=str(z["stdout"]).splitlines(), tree=tree,
                         params=bridge.params_from_jax(tree, cfg, "cpu"))
    return out


# what differs between the two packages' lines by design: wall times, and
# the reference's compile counts where the port prints kernel launches
_TIMES = re.compile(r"\(\d+ms (prefill|decode), ")
_COMPILES = re.compile(r"\d+ decode compile\(s\), ")


def _normalized(lines):
    return [_COMPILES.sub("", _TIMES.sub("(", ln)) for ln in lines
            if "kernel launches" not in ln and "fused decode" not in ln]


_CHAIN = re.compile(r"(tokens=| decode )\[([^\]]*)\]")


def _chain(line):
    """A printed token list's tokens (numpy scalars print as
    ``np.int32(5)``)."""
    inner = _CHAIN.search(line).group(2)
    return [int(t) for t in re.findall(r"\((\d+)\)", inner)] \
        if "np." in inner else [int(t) for t in inner.split(",") if t]


def _prompts(name, vocab):
    """The prompts each example draws, in its order."""
    rng = np.random.default_rng(0)
    if name == "quickstart":
        return [rng.integers(0, vocab, 6, dtype=np.int32).astype(np.int32)
                for _ in range(6)]
    return [rng.integers(0, vocab, 5, dtype=np.int64).astype(np.int32)
            for _ in range(3)]


def _split_at_a_tie(name, tree, prompt, want, got):
    """Where ``got`` parts from the reference's chain ``want``: the
    reference's logits after the prompt and the tokens before the split
    must hold the port's token within one bf16 ulp of their top.  Returns
    (position, reference token, port token, gap, ulp)."""
    k = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    cfg = ref_reduced(ref_get_config(REFERENCE_EXAMPLES[name]))
    seq = np.concatenate([prompt, np.asarray(want[:k], np.int32)])
    logits, _ = ref_model_api(cfg).prefill(
        tree, cfg, {"tokens": jnp.asarray(seq)[None]})
    row = np.asarray(logits[0], np.float32)
    top = float(row.max())
    ulp = 2.0 ** (math.frexp(top)[1] - 8)
    gap = top - float(row[got[k]])
    assert gap <= ulp, (f"{name}: the chain parts at token {k} "
                        f"({want[k]} -> {got[k]}) above a bf16 tie: the "
                        f"reference's logit gap {gap} over one ulp {ulp}")
    return k, want[k], got[k], gap, ulp


@pytest.mark.parametrize("name", sorted(REFERENCE_EXAMPLES))
def test_example_prints_the_reference_examples_lines(reference_runs, name,
                                                     capsys):
    ref = reference_runs[name]
    mod = _example(f"torch_{name}")
    assert mod.main(["--device", "cpu"], params=ref["params"]) == 0
    lines = _normalized(capsys.readouterr().out.splitlines())
    want = _normalized(ref["lines"])
    assert len(lines) == len(want)
    chains = [i for i, ln in enumerate(want) if _CHAIN.search(ln)]
    assert len(chains) == {"quickstart": 6, "llm_case_study": 3}[name]
    prompts = _prompts(name, reduced(get_config(
        REFERENCE_EXAMPLES[name])).vocab_size)
    splits = []
    for i, (a, b) in enumerate(zip(lines, want)):
        if i not in chains:
            assert a == b
            continue
        # the line around the chain equal, the chain equal or split at a tie
        assert _CHAIN.sub("", a) == _CHAIN.sub("", b)
        if _chain(a) != _chain(b):
            n = chains.index(i)
            splits.append((n, *_split_at_a_tie(
                name, ref["tree"], prompts[n], _chain(b), _chain(a))))
    # named in the output: (request, position, reference token, port
    # token, reference logit gap, one bf16 ulp)
    print(f"{name}: chains split at bf16 ties: {splits}")
    assert len(splits) < len(chains)


def test_serve_cluster_under_chaos_accounts_for_every_rid(tmp_path,
                                                         capsys):
    mod = _example("torch_serve_cluster")
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.prom"
    assert mod.main(["--device", "cpu", "--requests", "9", "--chaos",
                     "--trace-out", str(trace), "--metrics-out",
                     str(metrics)]) == 0
    out = capsys.readouterr().out
    assert "chaos: crash server" in out
    assert re.search(r"accounted 9/9", out)
    served = int(re.search(r"served (\d+)/9 requests", out).group(1))
    verdicted = int(re.search(r"(\d+) verdicted", out).group(1))
    assert served + verdicted == 9 and served > 0
    events = json.loads(trace.read_text())
    assert len(events.get("traceEvents", events)) > 0
    assert "epara_" in metrics.read_text()


def test_train_small_lowers_the_loss_and_reads_its_checkpoint_back(
        tmp_path, capsys):
    mod = _example("torch_train_small")
    ckpt = tmp_path / "small"
    assert mod.main(["--device", "cpu", "--steps", "3", "--checkpoint",
                     str(ckpt)]) == 0
    out = capsys.readouterr().out
    last, first = map(float, re.search(
        r"final loss ([\d.]+) \(first ([\d.]+)\)", out).groups())
    assert last < first
    m = re.search(r"checkpoint <- .*: step (\d+), (\d+) leaves; eval loss "
                  r"([\d.]+) restored \(untrained ([\d.]+)\)", out)
    assert m is not None and int(m.group(1)) == 3
    assert (tmp_path / "small.npz").exists()
    assert float(m.group(3)) < float(m.group(4))


def test_card_config_widens_only_a_head_dim_no_kernel_serves():
    """On the card the examples' reduced configs (head dim 32) serve at the
    attention kernels' narrowest width, 64, with their head counts; on
    the CPU, and for a width the kernels have, the config is unchanged."""
    from repro_torch.kernels import ops
    cfg = reduced(get_config("paligemma-3b"))
    assert ops.card_config(cfg, "cpu") is cfg
    wide = ops.card_config(cfg, "cuda")
    assert (wide.head_dim, wide.num_heads, wide.num_kv_heads) == (64, 4, 1)
    assert wide.d_model == cfg.d_model
    full = get_config("zamba2-7b")
    assert ops.card_config(full, "cuda") is full


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_llm_case_study",
                                  "torch_serve_cluster",
                                  "torch_train_small"])
def test_examples_want_the_card_unless_told_otherwise(name, monkeypatch):
    """Without ``--device cpu`` an example runs on the card, and where
    there is none it raises before serving or training anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main([])
