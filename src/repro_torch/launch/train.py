"""The training CLI: train a (reduced or full) model on the synthetic LM
pipeline, the counterpart of ``repro.launch.train``, with ``--device``
(the card by default; without one it raises, so pass ``cpu`` for the
plain path on the CPU).

  python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced \
      --steps 200 --batch 8 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config
from repro_torch.data import synthetic_token_batches
from repro_torch.models import build_model, tree_tensors
from repro_torch.models.common import resolve_device
from repro_torch.training import AdamWConfig, save_checkpoint, train


def main(argv=None, opt_cfg: AdamWConfig = AdamWConfig()):
    """Parse ``argv`` (the command line when None), train, and return the
    trained params and the history. ``opt_cfg`` gives the optimizer's
    settings but its learning rate, which is ``--lr``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    n_params = sum(p.numel() for p in tree_tensors(params))
    print(f"[train] {cfg.name} ({'reduced' if args.reduced else 'full'}): "
          f"{n_params/1e6:.1f}M params")

    data = synthetic_token_batches(
        cfg.vocab_size, args.batch, args.seq, seed=args.seed,
        with_frames=cfg.is_encoder_decoder,
        frame_len=cfg.encoder_seq, d_model=cfg.d_model)

    def log(i, m):
        print(f"[train] step {i:5d} loss {m['loss']:.4f} "
              f"gnorm {m['grad_norm']:.3f} wall {m['wall_s']:.1f}s")

    params, opt_state, history = train(
        model, params, data, steps=args.steps,
        opt_cfg=dataclasses.replace(opt_cfg, lr=args.lr), callback=log)

    if args.checkpoint:
        save_checkpoint(args.checkpoint, params)
        print(f"[train] checkpoint -> {args.checkpoint}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return params, history


if __name__ == "__main__":
    main()
