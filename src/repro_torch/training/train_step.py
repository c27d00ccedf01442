"""Training step: chunked cross-entropy loss, gradients, optimizer update
(the reference's ``repro/training/train_step.py``).

The loss runs the sequence in chunks, each under a non-reentrant
checkpoint, so the (B, L, vocab) f32 logits are never materialized and no
chunk's (B, chunk, vocab) block is kept for the backward: at minicpm-2b's
122,753-token vocabulary and 4096 tokens a microbatch, the whole logits
would take 2 GB and a saved block per chunk as much again.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_api

from .tree import tree_leaves, tree_map, tree_unflatten

DEFAULT_LOSS_CHUNK = 512
MOE_AUX_WEIGHT = 0.01


def chunked_cross_entropy(hidden, labels, logits_fn, *,
                          chunk: int = DEFAULT_LOSS_CHUNK,
                          ignore_id: int = -1):
    """hidden (B, L, d), labels (B, L) -> the mean NLL (f32) over the
    positions whose label is not ``ignore_id``, chunk by chunk over L."""
    L = hidden.shape[1]
    chunk = min(chunk, L)

    def per_chunk(h, y):
        logits = logits_fn(h).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y.clamp_min(0).long()[..., None])
        mask = (y != ignore_id).float()
        return ((logz - gold[..., 0]) * mask).sum(), mask.sum()

    total = count = 0.0
    for c0 in range(0, L, chunk):
        s, n = checkpoint(per_chunk, hidden[:, c0:c0 + chunk],
                          labels[:, c0:c0 + chunk], use_reentrant=False)
        total, count = total + s, count + n
    return total / torch.clamp_min(count, 1.0)


def make_loss_fn(cfg: ModelConfig, *,
                 loss_chunk: int = DEFAULT_LOSS_CHUNK) -> Callable:
    """loss_fn(params, batch) -> (loss, {"nll", "aux"}).  Raises for a
    family whose training forward is not ported."""
    api = model_api(cfg)
    if api.forward_hidden is None:
        raise NotImplementedError(
            f"training the {cfg.family!r} family is not ported to "
            f"repro_torch yet: ROADMAP.md Queue 1 item 12")

    def loss_fn(params, batch: Dict[str, Any]):
        hidden, aux = api.forward_hidden(params, cfg, batch, train=True)
        lf = lambda h: api.logits_fn(params, cfg, h)
        loss = chunked_cross_entropy(hidden, batch["labels"], lf,
                                     chunk=loss_chunk)
        return loss + MOE_AUX_WEIGHT * aux, {"nll": loss, "aux": aux}

    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, metrics), grads) of ``loss_fn(params, batch)``, grads a
    tree of ``params``' keys in their dtypes; nothing is left attached to
    ``params``."""
    with torch.enable_grad():
        tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, optimizer, *,
                    loss_chunk: int = DEFAULT_LOSS_CHUNK,
                    num_microbatches: int = 1,
                    accum_dtype=torch.float32) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); the optimizer updates params and state in place.

    ``num_microbatches`` = k > 1 runs the batch in k slices of B / k rows
    and sums the gradients in ``accum_dtype`` (g / k each): activation
    memory scales with B / k while the update sees the whole batch's
    gradient.  ``metrics["grad_norm"]`` is the global f32 norm of the
    gradient the update sees."""
    loss_fn = make_loss_fn(cfg, loss_chunk=loss_chunk)
    k = num_microbatches

    def train_step(params, opt_state, batch):
        if k == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            B = batch["tokens"].shape[0]
            assert B % k == 0, f"batch {B} % microbatches {k}"
            n = B // k
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                   device=p.device), params)
            loss = aux = 0.0
            for i in range(k):
                mb = {name: x[i * n:(i + 1) * n] for name, x in batch.items()}
                (mb_loss, mb_metrics), g = value_and_grad(loss_fn, params, mb)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi.to(accum_dtype) / k)
                del g
                loss = loss + mb_loss / k
                aux = aux + mb_metrics["aux"] / k
            metrics = {"nll": loss, "aux": aux}
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        new_params, new_state = optimizer.update(grads, opt_state, params)
        return new_params, new_state, dict(metrics, loss=loss,
                                           grad_norm=gnorm)

    return train_step


def make_eval_step(cfg: ModelConfig, *,
                   loss_chunk: int = DEFAULT_LOSS_CHUNK) -> Callable:
    loss_fn = make_loss_fn(cfg, loss_chunk=loss_chunk)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return dict(metrics, loss=loss)

    return eval_step
