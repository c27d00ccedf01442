"""Training of the MoE, SSM, audio, VLM and hybrid families: the PyTorch
port against the JAX reference.

Each family runs a float32 toy config (``conftest.toy_config`` with the
family's fields; 2 layers at d 64, the hybrid 5 layers with the shared
block every 2, so two applications and a tail layer).  Weights are built
by the reference and carried over with ``bridge.params_from_jax``; tokens
are made with numpy from a seed, with ignored labels and a loss chunk of 7
(ragged chunks).  The reference runs ``impl="ref"``: ``jax.grad`` cannot
differentiate its Pallas grouped GEMM or SSD scan (it has a custom VJP for
flash attention only), which ``test_reference_cannot_grad_its_pallas_kernel``
holds.

Tolerances: the hidden states, the loss and every leaf's gradient of
``make_loss_fn`` to atol = rtol = 1e-5 (f32 sums in other orders), as
``test_torch_training.py``; the grouped GEMM's and the SSD scan's own
gradients to 1e-5 as well (the scan's chunk sums stay within it at these
sizes); one scan's gradients in two chunkings, where the decay exponents
reach ~380, to 1e-3 (see that test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import toy_config
from repro.kernels import ops as jops
from repro.models.registry import model_api as jmodel_api
from repro.training import train_step as jtrain_step
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_api
from repro_torch.training import train_step
from repro_torch.training.tree import tree_leaves, tree_paths

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

TOL = 1e-5
SSM = dict(ssm_state=16, ssm_headdim=16, ssm_chunk=8)
FAMILIES = {
    "moe": dict(family="moe", num_experts=4, experts_per_token=2,
                sliding_window=12),
    "ssm": dict(family="ssm", **SSM),
    "audio": dict(family="audio", encoder_layers=2, encoder_len=24,
                  norm="layernorm", activation="gelu_mlp"),
    "vlm": dict(family="vlm", prefix_len=6, activation="geglu",
                tie_embeddings=True, num_kv_heads=1),
    "hybrid": dict(family="hybrid", num_layers=5, attn_every=2, **SSM),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


def _jpaths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(leaf, np.float32) for path, leaf in flat}


def _setup(family, seed=0):
    cfg = toy_config(**FAMILIES[family])
    # jitted: the eager init dispatches each leaf's draws one by one
    params = jax.jit(jmodel_api(cfg).init, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                     _mirror(cfg), "cpu")
    return cfg, params, tparams


def _batch(cfg, B=2, L=20, seed=1):
    """Tokens and labels (B, L), the first three labels of row 0 ignored,
    and the stub frame or image embeddings for audio and the VLM."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    labels[0, :3] = -1
    arrays = {"tokens": tokens, "labels": labels}
    rows = {"audio": cfg.encoder_len, "vlm": cfg.prefix_len}.get(cfg.family)
    if rows:
        arrays["embeddings"] = rng.normal(
            size=(B, rows, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: _t(v) for k, v in arrays.items()})


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_every_grad_match_reference(family):
    """forward_hidden(train=True) (the hidden rows and the aux loss), the
    chunked loss and every leaf's gradient against
    ``jax.value_and_grad(make_loss_fn(cfg, impl="ref"))``; the VLM's
    hidden rows cover prefix and text, its loss the text alone."""
    cfg, params, tparams = _setup(family)
    jb, tb = _batch(cfg)
    tcfg = _mirror(cfg)
    jloss_fn = jtrain_step.make_loss_fn(cfg, loss_chunk=7, impl="ref")

    @jax.jit
    def reference(p, b):            # one compile for both
        hidden = jmodel_api(cfg).forward_hidden(p, cfg, b, train=True,
                                                impl="ref")
        return hidden, jax.value_and_grad(jloss_fn, has_aux=True)(p, b)

    (jh, jaux), ((jloss, jm), jgrads) = reference(params, jb)
    th, aux = model_api(tcfg).forward_hidden(tparams, tcfg, tb, train=True)
    assert th.shape == (2, 20 + cfg.prefix_len, cfg.d_model)
    _close(th.detach().numpy(), jh)
    _close(aux.item(), jaux)
    if family == "moe":
        assert aux.item() > 0
    else:
        assert aux.item() == 0.0
    loss_fn = train_step.make_loss_fn(tcfg, loss_chunk=7)
    (loss, metrics), grads = train_step.value_and_grad(loss_fn, tparams, tb)
    _close(loss.item(), jloss)
    _close(metrics["nll"].item(), jm["nll"])
    _close(metrics["aux"].item(), jm["aux"])
    got, want = tree_paths(grads), _jpaths(jgrads)
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert torch.isfinite(g).all(), path
        _close(g.numpy(), want[path], msg=path)
    assert not any(p.requires_grad for p in tree_leaves(tparams))


# ---------------------------------------------------------------------------
# the grouped GEMM and the SSD scan under autograd
# ---------------------------------------------------------------------------

def _gmm_inputs(seed=2, E=3, C=5, K=6, N=7):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(E, C, K), f(E, K, N), f(E, C, N)


def test_grouped_matmul_grads_match_jax_grad():
    """``ops.grouped_matmul`` under autograd goes through
    ``_GroupedMatmul`` (dX = dY W^T, dW = X^T dY, on the CPU through the
    plain version) and agrees with ``jax.grad`` of the reference's
    ``ops.grouped_matmul(impl="ref")``; with no graph recorded it is the
    forward alone."""
    lhs, rhs, dy = _gmm_inputs()
    want = jax.grad(lambda a, b: jnp.sum(
        jops.grouped_matmul(a, b, impl="ref") * dy), argnums=(0, 1))(
            jnp.asarray(lhs), jnp.asarray(rhs))
    tl, tr = (_t(a).requires_grad_(True) for a in (lhs, rhs))
    out = ops.grouped_matmul(tl, tr)
    assert "_GroupedMatmul" in out.grad_fn.name()
    (out * _t(dy)).sum().backward()
    _close(tl.grad.numpy(), want[0], msg="dX")
    _close(tr.grad.numpy(), want[1], msg="dW")
    # one operand alone
    tr2 = _t(rhs).requires_grad_(True)
    (ops.grouped_matmul(_t(lhs), tr2) * _t(dy)).sum().backward()
    _close(tr2.grad.numpy(), want[1], msg="dW alone")
    with torch.no_grad():
        assert ops.grouped_matmul(tl, tr).grad_fn is None


def _ssd_inputs(seed=3, Bb=2, L=21, H=4, P=8, G=2, N=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    dt = np.log1p(np.exp(f(Bb, L, H) - 1.0)).astype(np.float32)
    A = -np.exp(0.5 * f(H)).astype(np.float32)
    return (f(Bb, L, H, P), dt, A, f(Bb, L, G, N), f(Bb, L, G, N), f(H),
            f(Bb, L, H, P))


def test_ssd_scan_grads_match_jax_grad():
    """``ops.ssd_scan`` under autograd goes through ``_SsdScan``, whose
    backward recomputes the plain chunked scan: the gradients of x, dt,
    A, B, C and D (chunks of 8 over 21 steps, so the last is ragged)
    agree with ``jax.grad`` of the reference's ``ops.ssd_scan(impl=
    "ref")``.  A gradient of the final state or of ``initial_state``
    raises rather than come back zero."""
    *args, dy = _ssd_inputs()
    want = jax.grad(lambda *a: jnp.sum(
        jops.ssd_scan(*a, chunk=8, impl="ref")[0] * dy),
        argnums=tuple(range(6)))(*map(jnp.asarray, args))
    targs = [_t(a).requires_grad_(True) for a in args]
    y, state = ops.ssd_scan(*targs, chunk=8)
    assert "_SsdScan" in y.grad_fn.name()
    (y * _t(dy)).sum().backward()
    for name, t, w in zip(("x", "dt", "A", "B", "C", "D"), targs, want):
        _close(t.grad.numpy(), w, msg=f"d{name}")
    y, state = ops.ssd_scan(*targs, chunk=8)
    with pytest.raises(NotImplementedError, match="final state"):
        state.sum().backward()
    h0 = torch.zeros(2, 4, 8, 8, requires_grad=True)
    y, _ = ops.ssd_scan(*targs, chunk=8, initial_state=h0)
    with pytest.raises(NotImplementedError, match="initial_state"):
        y.sum().backward()


def test_ssd_scan_grad_is_finite_where_the_reference_overflows():
    """Steps whose decay dt * |A| sums past f32's exp range within one
    chunk (dt = 2 over chunks of 64): the reference's plain scan takes
    exp(cum_t - cum_s) for s > t too and masks it after the exp, so its
    ``jax.grad`` is NaN (0 * inf); the port masks the exponent before the
    exp, so ``_SsdScan``'s gradients are finite and equal the same scan's
    in chunks of 8, where nothing overflows, to 1e-3: the two chunkings
    sum exponents of up to ~380 in other orders, and the exp turns their
    f32 rounding (~4e-5 there) into that much relative error."""
    *args, dy = _ssd_inputs(L=64)
    args[1] = np.full_like(args[1], 2.0)
    want = jax.grad(lambda *a: jnp.sum(
        jops.ssd_scan(*a, chunk=64, impl="ref")[0] * dy),
        argnums=tuple(range(6)))(*map(jnp.asarray, args))
    assert any(np.isnan(np.asarray(w)).any() for w in want)
    grads = {}
    for chunk in (64, 8):
        targs = [_t(a).requires_grad_(True) for a in args]
        y, _ = ops.ssd_scan(*targs, chunk=chunk)
        (y * _t(dy)).sum().backward()
        grads[chunk] = [t.grad.numpy() for t in targs]
    for name, g, w in zip(("x", "dt", "A", "B", "C", "D"), grads[64],
                          grads[8]):
        assert np.isfinite(g).all(), name
        _close(g, w, tol=1e-3, msg=f"d{name}")


@pytest.mark.parametrize("kernel", ["grouped_matmul", "ssd_scan"])
def test_reference_cannot_grad_its_pallas_kernel(kernel):
    """Why the parity tests hold against ``impl="ref"``: ``jax.grad``
    through the reference's Pallas grouped GEMM or SSD scan (interpret
    mode) fails in Pallas's JVP rule with an ``AssertionError``.  If a
    JAX upgrade lets it through, this test says so."""
    if kernel == "grouped_matmul":
        lhs, rhs, dy = _gmm_inputs()
        fn = lambda a, b: jnp.sum(jops.grouped_matmul(
            a, b, impl="pallas_interpret") * dy)
        args = (lhs, rhs)
    else:
        *args, dy = _ssd_inputs(L=16, G=1)
        fn = lambda x, *rest: jnp.sum(jops.ssd_scan(
            x, *rest, chunk=8, impl="pallas_interpret")[0] * dy)
    with pytest.raises(AssertionError):
        jax.grad(fn)(*map(jnp.asarray, args))
