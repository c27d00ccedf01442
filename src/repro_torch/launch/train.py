"""Training launcher: the reference's ``repro/launch/train.py`` with its
flags, plus ``--device`` and ``--stub-embeddings``; ``--layers`` also cuts
the full config's depth (the reference applies it to ``--reduced`` only).

On the card (the default) it trains the full config, e.g. minicpm-2b at
its published width with the reference's ``train_4k`` sequence length:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
      --batch 2 --seq 4096 --microbatches 2 --steps 4 --lr 1e-3

and ``--device cpu --reduced`` trains the smoke-sized variant on the CPU
(the kernels' plain versions).  Every family trains; the audio and VLM
batches carry the reference's zero frame or image embeddings beside the
tokens (for the VLM ``--seq`` counts the text, after its image prefix),
or with ``--stub-embeddings normal`` random ones: paligemma-3b at full
depth needs them, its gradient overflows on zero image rows.
zamba2-7b fits one 80 GB card with ``--optimizer adafactor`` (AdamW's
state and the weights would take 81.5 GB).  Weights are random from seed
0, batches come from ``TokenPipeline`` (seed 0).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Iterator, List

import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import launch_counts
from repro_torch.models.registry import model_api
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import tree_leaves


def build_batch(cfg, tokens, labels, device, *, stub: str = "zeros",
                seed: int = 0) -> Dict[str, torch.Tensor]:
    """Token and label arrays (B, L) -> the batch on ``device``, with the
    stub frontend's ``embeddings`` in the compute dtype: (B, encoder_len,
    d_model) frames for the audio family, (B, prefix_len, d_model) image
    rows for the VLM.  ``stub="zeros"`` gives the reference's zeros,
    ``"normal"`` standard normal draws from ``seed``."""
    batch = {"tokens": torch.as_tensor(tokens, device=device),
             "labels": torch.as_tensor(labels, device=device)}
    rows = {"audio": cfg.encoder_len, "vlm": cfg.prefix_len}.get(cfg.family)
    if rows is not None:
        shape = (batch["tokens"].shape[0], rows, cfg.d_model)
        if stub == "zeros":
            emb = torch.zeros(shape, device=device)
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            emb = torch.randn(shape, generator=gen, device=device)
        batch["embeddings"] = emb.to(cfg.compute_dtype)
    return batch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-sized variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override reduced d_model (e.g. 512 for ~100M)")
    ap.add_argument("--layers", type=int, default=None,
                    help="the layer count: of the reduced variant, or of "
                         "the full config (its width kept, its depth cut)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--stub-embeddings", default="zeros",
                    choices=["zeros", "normal"],
                    help="the audio and VLM stub frontends' embeddings: "
                         "the reference's zeros, or normal draws seeded by "
                         "the step (paligemma-3b's zero image rows stay "
                         "zero through its 18 layers, where each RMSNorm's "
                         "backward scales by 1/sqrt(eps): the gradient "
                         "overflows, in the reference too)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run the plain versions on the CPU; the "
                         "default is the card")
    return ap


def config_for(argv=None):
    """The model config the flags ``argv`` train: the full config, its
    reduced variant with ``--d-model`` and ``--layers`` applied, or the
    full config cut to ``--layers``."""
    args = _parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        over = {}
        if args.d_model:
            over = dict(d_model=args.d_model, num_heads=args.d_model // 64,
                        num_kv_heads=max(1, args.d_model // 128),
                        head_dim=64, d_ff=args.d_model * 3,
                        vocab_size=4096)
        if args.layers:
            over["num_layers"] = args.layers
        return reduced(cfg, **over)
    if args.layers:
        return dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def train_steps(argv=None) -> Iterator[Dict[str, Any]]:
    """Sets up as the flags say and trains, yielding each step's ``loss``,
    ``grad_norm``, ``step_s`` (host wall seconds, ending in a read of the
    loss), ``launches`` (each kernel's launches in the step) and
    ``static_bytes`` (the weights and the optimizer state).  Saves the
    checkpoint after the last step."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_for(argv)
    params = model_api(cfg).init(0, cfg, device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} family={cfg.family} params={n_params / 1e6:.1f}M "
          f"device={where}")

    opt = get_optimizer(args.optimizer, args.lr)
    state = opt.init(params)
    static = sum(t.numel() * t.element_size() for tree in (params, *state)
                 for t in tree_leaves(tree))
    step_fn = make_train_step(cfg, opt, num_microbatches=args.microbatches)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, seed=0)

    t0 = time.time()
    for step in range(args.steps):
        raw = pipe.batch(step)
        batch = build_batch(cfg, raw["tokens"] % cfg.vocab_size,
                            raw["labels"] % cfg.vocab_size, device,
                            stub=args.stub_embeddings, seed=step)
        before, ts = launch_counts(), time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        out = {"loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "step_s": time.perf_counter() - ts,
               "static_bytes": static,
               "launches": {k: n - before[k]
                            for k, n in launch_counts().items()}}
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tps = (step + 1) * args.batch * args.seq / dt
            print(f"step {step:5d} loss {out['loss']:8.4f} "
                  f"gnorm {out['grad_norm']:8.3f} ({tps:8.0f} tok/s)")
        yield out
    if args.checkpoint:
        path = checkpoint.save(args.checkpoint, params, step=args.steps)
        print(f"checkpoint -> {path}")


def run(argv=None) -> Dict[str, List[Any]]:
    """Trains as the flags say and returns the per-step ``losses``,
    ``grad_norms``, ``step_s``, ``launches`` and ``static_bytes`` of
    ``train_steps``."""
    names = {"losses": "loss", "grad_norms": "grad_norm",
             "step_s": "step_s", "launches": "launches",
             "static_bytes": "static_bytes"}
    out = {key: [] for key in names}
    for m in train_steps(argv):
        for key, name in names.items():
            out[key].append(m[name])
    if out["losses"]:
        print(f"final loss {out['losses'][-1]:.4f} "
              f"(first {out['losses'][0]:.4f})")
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
