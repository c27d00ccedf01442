"""Train a small model through the PyTorch/CUDA port
(``examples/train_small.py`` on the JAX package): a reduced config
(``--arch``, codeqwen1.5-7b by default) through the whole training
substrate (chunked loss, AdamW, checkpointing, the synthetic pipeline) by
way of ``repro_torch.launch.train``, on the card (``--device cpu``: the
kernels' plain versions on the CPU).

After the last step the checkpoint is read back into a fresh tree of the
same config, and the restored weights' loss on the first batch is
printed beside the untrained weights' (``eval loss``), so a run shows
the trained weights survived the round trip.  The checkpoint goes under
the temporary directory unless ``--checkpoint`` says where.

  PYTHONPATH=src python examples/torch_train_small.py [--steps 300] \
      [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import train
from repro_torch.models.registry import model_api
from repro_torch.training import checkpoint
from repro_torch.training.train_step import make_eval_step
from repro_torch.training.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("--checkpoint", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_small"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # d_model=512, 2 layers, d_ff=1536, vocab 4096 -> ~15M backbone; bump
    # layers for ~100M when you have the cycles:
    train_argv = ["--arch", args.arch, "--reduced", "--d-model", "512",
                  "--layers", "2", "--steps", str(args.steps),
                  "--batch", "8", "--seq", "256", "--lr", "3e-3",
                  "--checkpoint", args.checkpoint, "--log-every", "20",
                  "--device", str(device)]
    train.main(train_argv)

    cfg = train.config_for(train_argv)
    fresh = model_api(cfg).init(0, cfg, device)
    restored = checkpoint.restore(args.checkpoint, fresh)
    step = checkpoint.restored_step(args.checkpoint)
    raw = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                        batch_size=8, seed=0).batch(0)
    batch = train.build_batch(cfg, raw["tokens"] % cfg.vocab_size,
                              raw["labels"] % cfg.vocab_size, device)
    evaluate = make_eval_step(cfg)
    before = float(evaluate(fresh, batch)["loss"])
    after = float(evaluate(restored, batch)["loss"])
    print(f"checkpoint <- {args.checkpoint}: step {step}, "
          f"{len(tree_leaves(restored))} leaves; eval loss {after:.4f} "
          f"restored (untrained {before:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
