"""Training launcher (counterpart of ``src/repro/launch/train.py``).

End-to-end training run (real data pipeline, optimizer, checkpointing) with
``--arch`` selecting a registry config the port builds (smoke variant unless
``--full``), on the card unless ``--device cpu``.  Prints the reference's
lines and exits 0 when the loss improved.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --steps 20 --device cpu --ckpt-dir ckpt

``--arch`` defaults to llama-3.1-8b: the reference's default, qwen2.5-3b,
needs QKV bias, which the port does not build yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_checkpoint, torch_param_dtypes, torch_params_to_jax
from repro_torch.configs import get_config
from repro_torch.data import token_stream_batches
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.tokenizer import HashWordTokenizer
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.optimizer import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-3.1-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="use the full (production) config instead of smoke")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    model = build_model(cfg)
    tok = HashWordTokenizer(cfg.vocab_size)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M seq={args.seq} "
          f"batch={args.batch}")

    opt_cfg = AdamWConfig(lr=args.lr)
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              total_steps=args.steps)
    opt = init_opt_state(params)
    stream = token_stream_batches(tok, args.batch, args.seq)

    t0 = time.time()
    first = last = None
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v).to(device) for k, v in next(stream).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        loss = metrics["loss"]
        if first is None:
            first = loss
        last = loss
        if step % args.log_every == 0 or step == args.steps - 1:
            tps = args.batch * args.seq * (step + 1) / (time.time() - t0)
            print(f"step {step:4d} loss {loss:.4f} tok/s {tps:,.0f}")
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.steps, torch_params_to_jax(params, cfg),
                               {"arch": args.arch}, dtypes=torch_param_dtypes(params, cfg))
        print("checkpoint:", path)
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
