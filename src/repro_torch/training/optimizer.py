"""Optimizers on the port's parameter trees: AdamW and Adafactor, the
reference's (``repro/training/optimizer.py``) math and state dtypes.

Moments and second-moment factors are f32; each update is computed in f32
and cast back to the parameter's dtype; weight decay applies to every
leaf.  Unlike the reference, which returns new trees, ``update`` writes
the new parameters and state into their own tensors (on minicpm-2b a
second copy of the 21.8 GB of AdamW moments would not leave room for the
step) and returns them.  A stacked leaf (layers, ...) is updated a layer
at a time with the same math, so its f32 temporaries are a layer's: five
of zamba2-7b's whole (81, 3584, 14576) mamba ``in_proj`` would take 17 GB
each.  Adafactor's update clip takes the RMS over the whole leaf, so it
sums over the layers first and applies the clip in a second pass.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from .tree import layer_slices, tree_leaves, tree_map


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(step=_step0(params), mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        for leaves in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
            for p, g, m, v in zip(*map(layer_slices, leaves)):
                g = g.float()
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g.square())
                u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
                p32 = p.float()
                u.add_(self.weight_decay * p32)
                p.copy_(p32.sub_(self.learning_rate * u))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any    # row second moment (or the full v for leaves under 2-D)
    vc: Any    # column second moment (a 0-d placeholder under 2-D)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second moment (Shazeer & Stern 2018), no first moment."""
    learning_rate: float = 3e-4
    decay: float = 0.8        # step-dependent: 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params) -> AdafactorState:
        f32 = dict(dtype=torch.float32)

        def vr_init(p):
            shape = p.shape[:-1] if p.ndim >= 2 else p.shape
            return torch.zeros(shape, device=p.device, **f32)

        def vc_init(p):
            shape = p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else ()
            return torch.zeros(shape, device=p.device, **f32)

        return AdafactorState(step=_step0(params),
                              vr=tree_map(vr_init, params),
                              vc=tree_map(vc_init, params))

    def _u(self, g, vr, vc, factored: bool):
        """The unclipped update g / sqrt(v) of one leaf or layer, from its
        already-updated second moment."""
        if factored:
            denom = vr.mean(dim=-1, keepdim=True)
            r = vr / torch.clamp_min(denom, self.eps)
            v = r[..., None] * vc[..., None, :]
        else:
            v = vr
        return g / torch.sqrt(torch.clamp_min(v, self.eps))

    @torch.no_grad()
    def update(self, grads, state: AdafactorState, params
               ) -> Tuple[Any, AdafactorState]:
        step = state.step + 1
        beta = 1.0 - step.float() ** (-self.decay)
        for p, g, vr, vc in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state.vr), tree_leaves(state.vc)):
            factored = p.ndim >= 2
            parts = (list(zip(p, g, vr, vc)) if p.ndim >= 3
                     else [(p, g, vr, vc)])
            sq = 0.0
            for _, gs, vrs, vcs in parts:     # the moments, and sum u^2
                gs = gs.float()
                g2 = gs.square() + self.eps
                if factored:
                    vrs.copy_(beta * vrs + (1 - beta) * g2.mean(dim=-1))
                    vcs.copy_(beta * vcs + (1 - beta) * g2.mean(dim=-2))
                else:
                    vrs.copy_(beta * vrs + (1 - beta) * g2)
                sq = sq + self._u(gs, vrs, vcs, factored).square().sum()
            norm = torch.sqrt(sq / p.numel())
            clip = torch.clamp_min(norm / self.clip_threshold, 1.0)
            for ps, gs, vrs, vcs in parts:    # the clipped update
                u = self._u(gs.float(), vrs, vcs, factored) / clip
                p32 = ps.float()
                if self.weight_decay:
                    u = u + self.weight_decay * p32
                ps.copy_(p32 - self.learning_rate * u)
        return params, AdafactorState(step=step, vr=state.vr, vc=state.vc)


def get_optimizer(name: str, learning_rate: float = 3e-4):
    if name == "adamw":
        return AdamW(learning_rate=learning_rate)
    if name == "adafactor":
        return Adafactor(learning_rate=learning_rate)
    raise ValueError(f"unknown optimizer {name!r}")
