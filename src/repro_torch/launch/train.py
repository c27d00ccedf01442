"""Training launcher: the reference's ``repro/launch/train.py`` with its
flags, plus ``--device``.

On the card (the default) it trains the full config, e.g. minicpm-2b at
its published width with the reference's ``train_4k`` sequence length:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
      --batch 2 --seq 4096 --microbatches 2 --steps 4 --lr 1e-3

and ``--device cpu --reduced`` trains the smoke-sized variant on the CPU
(the kernels' plain versions).  Weights are random from seed 0, batches
come from ``TokenPipeline`` (seed 0).  Only the dense family trains so
far; the others raise, naming ROADMAP.md Queue 1 item 12.
"""
from __future__ import annotations

import argparse
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


def build_batch(tokens, labels, device) -> Dict[str, torch.Tensor]:
    """Token and label arrays (B, L) -> the batch on ``device``.  (The
    reference also adds zero frame or image embeddings for the audio and
    VLM families, whose training is not ported.)"""
    return {"tokens": torch.as_tensor(tokens, device=device),
            "labels": torch.as_tensor(labels, device=device)}


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
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run the plain versions on the CPU; the "
                         "default is the card")
    return ap


def train_steps(argv=None) -> Iterator[Dict[str, Any]]:
    """Sets up as the flags say and trains, yielding each step's ``loss``,
    ``grad_norm``, ``step_s`` (host wall seconds, ending in a read of the
    loss) and ``launches`` (each kernel's launches in the step).  Saves
    the checkpoint after the last step."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
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
        cfg = reduced(cfg, **over)
    params = model_api(cfg).init(0, cfg, device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} family={cfg.family} params={n_params / 1e6:.1f}M "
          f"device={where}")

    opt = get_optimizer(args.optimizer, args.lr)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, num_microbatches=args.microbatches)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, seed=0)

    t0 = time.time()
    for step in range(args.steps):
        raw = pipe.batch(step)
        batch = build_batch(raw["tokens"] % cfg.vocab_size,
                            raw["labels"] % cfg.vocab_size, device)
        before, ts = launch_counts(), time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        out = {"loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "step_s": time.perf_counter() - ts,
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
    ``grad_norms``, ``step_s`` and ``launches`` of ``train_steps``."""
    names = {"losses": "loss", "grad_norms": "grad_norm",
             "step_s": "step_s", "launches": "launches"}
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
