"""The training path: the PyTorch port against the JAX reference.

Inputs and weights are made with numpy from a seed (weights by the
reference's ``init``, carried over with ``bridge.params_from_jax``); the
toy configs are float32 (head dim 16).  Tolerances:

* the flash backward's plain version against the Pallas kernels (interpret
  mode) and the reference's oracle: atol = rtol = 1e-5 (f32 sums in other
  orders; the Pallas kernels also block the keys);
* gradients through ``ops.flash_attention`` against ``jax.grad`` through
  the reference's ``ops.flash_attention(impl="pallas_interpret")``, and the
  hidden states, loss and every leaf's gradient of the whole loss: atol =
  rtol = 1e-5;
* optimizer updates on identical gradients: atol = rtol = 1e-6 (the same
  f32 formulas, elementwise);
* three train steps: losses to 1e-5, parameters to 1e-5 (AdamW divides by
  sqrt(v), so the steps pass f32 noise in the gradients on to the
  parameters, at most about lr times the noise's relative size);
* the data pipeline and checkpoints: exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import toy_config
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention_bwd import flash_attention_bwd_pallas
from repro.models import transformer as jtransformer
from repro.models.registry import model_api as jmodel_api
from repro.training import checkpoint as jcheckpoint
from repro.training import optimizer as joptimizer
from repro.training import train_step as jtrain_step
from repro_torch import bridge
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.training import checkpoint, optimizer, train_step
from repro_torch.training.tree import tree_leaves, tree_paths

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


def _close_trees(got, want_np, tol=TOL):
    """A torch tree against a reference tree already flattened by path."""
    got = tree_paths(got)
    assert sorted(got) == sorted(want_np)
    for path, g in got.items():
        _close(g.detach().float().numpy(), want_np[path], tol, path)


def _jpaths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(leaf, np.float32) for path, leaf in flat}


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------

BWD_CASES = {
    # id: ((B, Lq, Lk, Hq, Hkv, D), mask options); the first four are the
    # reference's own (tests/test_kernels.py), all at G = 2
    "causal": ((2, 40, 56, 4, 2, 16), dict(causal=True)),
    "window9": ((2, 40, 56, 4, 2, 16), dict(causal=True, window=9)),
    "noncausal": ((2, 40, 56, 4, 2, 16), dict(causal=False)),
    "prefix7": ((2, 40, 56, 4, 2, 16), dict(causal=True, prefix_len=7)),
    "gqa4_q_offset_kv_len": ((1, 20, 60, 8, 2, 16),
                             dict(causal=True, q_offset=30, kv_len=45)),
    "masked_rows": ((1, 30, 24, 4, 4, 16),
                    dict(causal=True, window=4, kv_len=10)),
}


def _bwd_inputs(shape, seed, kw):
    B, Lq, Lk, Hq, Hkv, D = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v, do = f(B, Lq, Hq, D), f(B, Lk, Hkv, D), f(B, Lk, Hkv, D), \
        f(B, Lq, Hq, D)
    out, lse = jref.flash_attention_fwd_ref(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), **kw)
    return q, k, v, np.asarray(out), np.asarray(lse), do


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_attention_bwd_ref_matches_pallas_and_oracle(case):
    shape, kw = BWD_CASES[case]
    args = _bwd_inputs(shape, len(case), kw)
    got = ref.flash_attention_bwd_ref(*map(_t, args), q_chunk=16,
                                      k_chunk=24, **kw)
    jargs = [jnp.asarray(a) for a in args]
    pallas = flash_attention_bwd_pallas(*jargs, q_block=16, k_block=16,
                                        interpret=True, **kw)
    oracle = jref.flash_attention_bwd_ref(*jargs, **kw)
    for name, g, p, o in zip("qkv", got, pallas, oracle):
        _close(g.numpy(), p, msg=f"d{name} vs Pallas")
        _close(g.numpy(), o, msg=f"d{name} vs oracle")
    # the default chunks (one chunk at these sizes) give the same answer
    whole = ref.flash_attention_bwd_ref(*map(_t, args), **kw)
    for g, w in zip(got, whole):
        _close(g.numpy(), w.numpy())
    if case == "masked_rows":
        dead = 10 - 1 + 4                  # rows at or past this see nothing
        assert not got[0][:, dead:].any()
        assert not got[1][:, 10:].any() and not got[2][:, 10:].any()


def test_flash_attention_bwd_prefix_past_the_query_tile():
    """A prefix that reaches past the last row of a Pallas query tile: the
    Pallas block test (flash_attention_bwd.py:50) skips that key block, so
    the Pallas backward drops the gradient through prefix keys that its
    own oracle keeps.  The port follows the element mask, i.e. the
    oracle."""
    kw = dict(causal=True, prefix_len=40)
    args = _bwd_inputs((1, 48, 48, 2, 1, 16), 5, kw)
    got = ref.flash_attention_bwd_ref(*map(_t, args), **kw)
    jargs = [jnp.asarray(a) for a in args]
    oracle = jref.flash_attention_bwd_ref(*jargs, **kw)
    pallas = flash_attention_bwd_pallas(*jargs, q_block=16, k_block=16,
                                        interpret=True, **kw)
    for g, o in zip(got, oracle):
        _close(g.numpy(), o)
    dq, dk, dv = (np.asarray(p) for p in pallas)
    assert np.abs(dq[:, :16] - got[0].numpy()[:, :16]).max() > 1e-3
    assert np.abs(dk[:, 16:40] - got[1].numpy()[:, 16:40]).max() > 1e-3
    # rows of the last tile see every key block; keys past the prefix are
    # seen only by rows of their own tile
    _close(got[0].numpy()[:, 32:], dq[:, 32:])
    _close(got[1].numpy()[:, 40:], dk[:, 40:])
    _close(got[2].numpy()[:, 40:], dv[:, 40:])


@pytest.mark.parametrize("case", ["causal", "window9", "noncausal",
                                  "gqa4_q_offset_kv_len"])
def test_flash_attention_grads_match_jax_grad(case):
    """Torch autograd through ``ops.flash_attention`` (its
    ``autograd.Function``) against ``jax.grad`` through the reference's
    ``custom_vjp`` with the Pallas kernels in interpret mode."""
    shape, kw = BWD_CASES[case]
    q, k, v, _, _, do = _bwd_inputs(shape, 11, kw)

    def jloss(q, k, v):
        out = jops.flash_attention(q, k, v, impl="pallas_interpret", **kw)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    (out * _t(do)).sum().backward()
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        _close(g.numpy(), w, msg=f"d{name}")


@pytest.mark.parametrize("case", ["rope_positions", "window_prefix",
                                  "cross", "no_rope"])
def test_attention_with_kv_matches_reference_layer(case):
    """``layers.attention_with_kv`` against the reference's
    ``layers.attention`` (impl="ref"): rope at given positions, a window
    and a prefix, cross-attention (keys not rotated), no rope; the
    output and the k, v it returns."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    cfg = toy_config()
    p = jax.tree.map(lambda a: a[0],
                     jmodel_api(cfg).init(jax.random.PRNGKey(8),
                                          cfg)["blocks"]["attn"])
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, p), _mirror(cfg),
                                "cpu")
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 14, cfg.d_model)).astype(np.float32)
    kw = {"rope_positions": dict(positions=np.arange(5, 19)[None]),
          "window_prefix": dict(window=4, prefix_len=3),
          "cross": dict(kv_x=rng.normal(size=(2, 9, cfg.d_model)).astype(
              np.float32), causal=False),
          "no_rope": dict(use_rope=False)}[case]
    conv = lambda f: {k: f(v) if isinstance(v, np.ndarray) else v
                      for k, v in kw.items()}
    want, (wk, wv) = jlayers.attention(p, cfg, jnp.asarray(x), impl="ref",
                                       **conv(jnp.asarray))
    got, (k, v) = layers.attention_with_kv(tp, _mirror(cfg), _t(x),
                                           **conv(_t))
    _close(got.numpy(), want)
    _close(k.numpy(), wk)
    _close(v.numpy(), wv)


# ---------------------------------------------------------------------------
# the model's loss and gradients
# ---------------------------------------------------------------------------

MODEL_CASES = {
    "gqa": {},
    "tied_fused": dict(tie_embeddings=True, fused_projections=True),
    "window": dict(sliding_window=6),
}


def _model(case, seed=0):
    cfg = toy_config(**MODEL_CASES[case])
    params = jmodel_api(cfg).init(jax.random.PRNGKey(seed), cfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                     _mirror(cfg), "cpu")
    return cfg, params, tparams


def _batch(cfg, B=2, L=20, seed=1, ignore=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    if ignore:
        labels[0, :3] = -1                 # ignored positions
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": _t(tokens), "labels": _t(labels)})


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_loss_and_every_grad_match_reference(case):
    """forward_hidden(train=True), the chunked loss (ragged chunks of 7,
    ignored labels) and every leaf's gradient against
    ``jax.value_and_grad(make_loss_fn(cfg))``."""
    cfg, params, tparams = _model(case)
    jb, tb = _batch(cfg)
    jh, _ = jtransformer.forward_hidden(params, cfg, jb, train=True)
    th, aux = transformer.forward_hidden(tparams, _mirror(cfg), tb,
                                         train=True)
    _close(th.detach().numpy(), jh)
    assert aux.item() == 0.0
    (jloss, _), jgrads = jax.value_and_grad(
        jtrain_step.make_loss_fn(cfg, loss_chunk=7), has_aux=True)(params, jb)
    loss_fn = train_step.make_loss_fn(_mirror(cfg), loss_chunk=7)
    (loss, metrics), grads = train_step.value_and_grad(loss_fn, tparams, tb)
    _close(loss.item(), jloss)
    _close(metrics["nll"].item(), jloss)
    _close_trees(grads, _jpaths(jgrads))
    assert not any(p.requires_grad for p in tree_leaves(tparams))
    eval_step = train_step.make_eval_step(_mirror(cfg), loss_chunk=7)
    assert eval_step(tparams, tb)["loss"].item() == pytest.approx(
        loss.item(), rel=1e-6)


@pytest.mark.parametrize("chunk", [5, 7, 20, 64])
def test_chunked_loss_matches_full_loss(chunk):
    """Every chunking of the loss equals the full-sequence loss and the
    reference's chunked loss; ignored labels are left out of both sum and
    count, and a batch with every label ignored has loss 0."""
    rng = np.random.default_rng(chunk)
    B, L, d, V = 2, 20, 8, 11
    h = rng.normal(size=(B, L, d)).astype(np.float32)
    w = rng.normal(size=(d, V)).astype(np.float32)
    y = rng.integers(0, V, (B, L)).astype(np.int32)
    y[1, 5:9] = -1
    got = train_step.chunked_cross_entropy(_t(h), _t(y), lambda x: x @ _t(w),
                                           chunk=chunk)
    logits = h @ w
    logz = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    gold = np.take_along_axis(logits, np.maximum(y, 0)[..., None], -1)[..., 0]
    keep = y != -1
    _close(got.item(), ((logz - gold) * keep).sum() / keep.sum())
    want = jtrain_step.chunked_cross_entropy(
        jnp.asarray(h), jnp.asarray(y), lambda x: x @ jnp.asarray(w),
        chunk=chunk)
    _close(got.item(), want)
    none = train_step.chunked_cross_entropy(
        _t(h), torch.full((B, L), -1, dtype=torch.int32),
        lambda x: x @ _t(w), chunk=chunk)
    assert none.item() == 0.0


# ---------------------------------------------------------------------------
# optimizers and train steps
# ---------------------------------------------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stack": {"a": (3, 4, 7), "b": (3, 4)},
              "bias": (5,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.normal(size=s).astype(np.float32)

    return draw(shapes)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name):
    """Two updates on identical params and gradients: params and every
    state leaf agree."""
    params, g1, g2 = _opt_tree(0), _opt_tree(1), _opt_tree(2)
    jopt = joptimizer.get_optimizer(name, 1e-2)
    topt = optimizer.get_optimizer(name, 1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = jax.tree.map(_t, params)
    ts = topt.init(tp)
    for g in (g1, g2):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(jax.tree.map(_t, g), ts, tp)
    _close_trees(tp, _jpaths(jp), 1e-6)
    assert int(ts.step) == int(js.step) == 2
    for field in js._fields[1:]:
        _close_trees(getattr(ts, field), _jpaths(getattr(js, field)), 1e-6)


def _three_steps_torch(cfg, tparams, k, batches):
    tcfg = _mirror(cfg)
    opt = optimizer.AdamW(learning_rate=1e-3)
    tp = jax.tree.map(torch.clone, tparams)
    state = opt.init(tp)
    step = train_step.make_train_step(tcfg, opt, loss_chunk=8,
                                      num_microbatches=k)
    losses, norms = [], []
    for _, tb in batches:
        tp, state, m = step(tp, state, tb)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return tp, losses, norms


@pytest.mark.parametrize("k", [1, 2])
def test_three_train_steps_match_reference(k):
    """Three AdamW steps with ``k`` microbatches: per-step losses and grad
    norms and the final parameters equal the reference's
    ``make_train_step``; one microbatch and two give equal results too (no
    label is ignored: with ignored labels the mean of the microbatches'
    means is another loss)."""
    cfg, params, tparams = _model("tied_fused", seed=3)
    batches = [_batch(cfg, B=4, L=12, seed=s, ignore=False)
               for s in range(3)]
    jstep = jax.jit(jtrain_step.make_train_step(
        cfg, joptimizer.AdamW(learning_rate=1e-3), loss_chunk=8,
        num_microbatches=k))
    jp, js = params, joptimizer.AdamW(learning_rate=1e-3).init(params)
    jlosses, jnorms = [], []
    for jb, _ in batches:
        jp, js, m = jstep(jp, js, jb)
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m["grad_norm"]))
    tp, losses, norms = _three_steps_torch(cfg, tparams, k, batches)
    _close(losses, jlosses)
    _close(norms, jnorms)
    _close_trees(tp, _jpaths(jp))
    other, other_losses, _ = _three_steps_torch(cfg, tparams, 3 - k, batches)
    _close(other_losses, losses)
    for a, b in zip(tree_leaves(other), tree_leaves(tp)):
        _close(a.numpy(), b.numpy())


def test_microbatches_must_divide_the_batch():
    cfg, _, tparams = _model("gqa")
    step = train_step.make_train_step(_mirror(cfg), optimizer.AdamW(),
                                      num_microbatches=3)
    _, tb = _batch(cfg, B=4)
    with pytest.raises(AssertionError, match="microbatches"):
        step(tparams, optimizer.AdamW().init(tparams), tb)


@pytest.mark.parametrize("family", ["moe", "ssm", "audio"])
def test_unported_families_refuse_to_train(family):
    """(The name predates their training.)  The family's training forward
    is wired in the registry and ``make_loss_fn``/``make_train_step``
    build; ``tests/test_torch_train_families.py`` holds their losses and
    gradients to the reference's."""
    from repro_torch.models import encdec, moe, ssm
    from repro_torch.models.registry import model_api
    cfg = dataclasses.replace(_mirror(toy_config()), family=family)
    module = {"moe": moe, "ssm": ssm, "audio": encdec}[family]
    assert model_api(cfg).forward_hidden is module.forward_hidden
    assert callable(train_step.make_loss_fn(cfg))
    assert callable(train_step.make_train_step(cfg, optimizer.AdamW()))


# ---------------------------------------------------------------------------
# data, checkpoints, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(257, 16, 3, 0),
                                                  (122753, 40, 2, 7)])
def test_token_pipeline_is_bit_identical(vocab, seq, batch, seed):
    mine = TokenPipeline(vocab_size=vocab, seq_len=seq, batch_size=batch,
                         seed=seed)
    theirs = JTokenPipeline(vocab_size=vocab, seq_len=seq, batch_size=batch,
                            seed=seed)
    for step in (0, 1, 5):
        a, b = mine.batch(step), theirs.batch(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(next(iter(mine))["tokens"],
                                  next(iter(theirs))["tokens"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_port_and_reference(tmp_path, dtype):
    """A checkpoint the port writes is restored by the reference's
    ``restore`` to the same values, and one the reference writes by the
    port's; both keep the step."""
    cfg = toy_config(dtype=dtype, param_dtype=dtype)
    params = jmodel_api(cfg).init(jax.random.PRNGKey(4), cfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                     _mirror(cfg), "cpu")
    path = checkpoint.save(str(tmp_path / "port"), tparams, step=7)
    back = jcheckpoint.restore(path, params)
    assert jcheckpoint.restored_step(path) == 7
    jflat, tflat = _jpaths(back), tree_paths(tparams)
    for key, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        assert leaf.dtype == jnp.dtype(dtype)
    for key, t in tflat.items():
        np.testing.assert_array_equal(jflat[key], t.float().numpy())
    jpath = jcheckpoint.save(str(tmp_path / "ref"), params, step=3)
    like = jax.tree.map(torch.zeros_like, tparams)
    mine = checkpoint.restore(jpath, like)
    assert checkpoint.restored_step(jpath) == 3
    for key, t in tree_paths(mine).items():
        assert t.dtype == tflat[key].dtype
        assert torch.equal(t, tflat[key]), key


LAUNCHER_ARCHS = {"minicpm-2b": "dense", "mamba2-2.7b": "ssm",
                  "whisper-large-v3": "audio", "mixtral-8x7b": "moe",
                  "paligemma-3b": "vlm", "zamba2-7b": "hybrid"}


@pytest.mark.parametrize("arch", sorted(LAUNCHER_ARCHS))
def test_train_launcher_lowers_the_loss_on_cpu(tmp_path, capsys, arch):
    """``--device cpu --reduced`` trains each family's reduced arch (bf16)
    with the plain versions: the loss falls, the step and final lines
    print, the checkpoint holds the trained step, and the audio and VLM
    batches carry their zero embeddings (or, with ``stub="normal"``,
    draws fixed by their seed).  The untied archs start near a
    uniform guess (a loss of ~6.7 over 512 tokens), where a step of 128
    tokens moves the loss by its own noise: 10 steps of 16 x 64 tokens
    at lr 1e-2 move it by more."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(arch))
    batch = train.build_batch(cfg, np.zeros((4, 32), np.int32),
                              np.zeros((4, 32), np.int32), "cpu")
    rows = {"audio": cfg.encoder_len, "vlm": cfg.prefix_len}.get(cfg.family)
    if rows is None:
        assert "embeddings" not in batch
    else:
        emb = batch["embeddings"]
        assert emb.shape == (4, rows, cfg.d_model) and not emb.any()
        assert emb.dtype == cfg.compute_dtype
        drawn = [train.build_batch(cfg, np.zeros((4, 32), np.int32),
                                   np.zeros((4, 32), np.int32), "cpu",
                                   stub="normal", seed=s)["embeddings"]
                 for s in (3, 3, 4)]
        assert drawn[0].shape == emb.shape and drawn[0].dtype == emb.dtype
        assert drawn[0].float().std() > 0.5
        assert torch.equal(drawn[0], drawn[1])
        assert not torch.equal(drawn[0], drawn[2])
    ckpt = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--arch", arch, "--reduced", "--steps", "10",
            "--batch", "16", "--seq", "64", "--lr", "1e-2", "--log-every",
            "1", "--checkpoint", ckpt]
    assert train.main([*argv, "--steps", "1"]) == 0
    capsys.readouterr()
    result = train.run(argv)
    out = capsys.readouterr().out
    assert f"arch={arch} family={LAUNCHER_ARCHS[arch]} params=" in out
    assert out.count("\nstep ") == 10 and "final loss" in out
    losses = result["losses"]
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert np.isfinite(result["grad_norms"]).all()
    assert losses[-1] < losses[0]
    assert all(not any(n.values()) for n in result["launches"])
    assert checkpoint.restored_step(ckpt) == 10
