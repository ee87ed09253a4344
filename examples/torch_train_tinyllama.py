"""Train a ~120M-parameter llama-family model for a few hundred steps on
the synthetic LM pipeline, demonstrating the port's training substrate
(AdamW, the remat train step, checkpointing): the port's counterpart of
``examples/train_tinyllama.py``. It runs on the card unless ``--device
cpu`` is given.

  PYTHONPATH=src python examples/torch_train_tinyllama.py --steps 300
  PYTHONPATH=src python examples/torch_train_tinyllama.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data import synthetic_token_batches
from repro_torch.models import build_model, tree_tensors
from repro_torch.models.common import resolve_device
from repro_torch.training import AdamWConfig, save_checkpoint, train


def config_120m():
    return get_config("tinyllama-1.1b").replace(
        name="tinyllama-120m",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=32000,
        dtype="float32", param_dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = config_120m()
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    n = sum(p.numel() for p in tree_tensors(params))
    print(f"{cfg.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps @ batch={args.batch} seq={args.seq} "
          f"on {device}")

    data = synthetic_token_batches(cfg.vocab_size, args.batch, args.seq,
                                   seed=0)

    def log(i, m):
        print(f"step {i:4d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.2f}  {m['wall_s']:.0f}s")

    params, _, hist = train(model, params, data, steps=args.steps,
                            opt_cfg=AdamWConfig(lr=6e-4, warmup_steps=50),
                            log_every=20, callback=log)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params)
    print(f"loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    assert hist[-1]["loss"] < hist[0]["loss"], "training must reduce loss"
    return hist


if __name__ == "__main__":
    main()
