"""Training launcher (counterpart of ``src/repro/launch/train.py``).

End-to-end training run (real data pipeline, optimizer, checkpointing) with
``--arch`` selecting a registry config the port builds (smoke variant unless
``--full``), on the card unless ``--device cpu``.  Prints the reference's
lines and exits 0 when the loss improved.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --steps 20 --device cpu --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny --device cpu

``--arch`` defaults to qwen2.5-3b, as the reference's does.  An audio or
encoder-decoder id (whisper-tiny) trains on random ``frames`` and a vision
stub (internvl2-26b) on random ``prefix_embeds`` beside the token stream,
drawn from ``np.random.default_rng(0)`` in the reference's order and shapes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint, torch_param_dtypes, torch_params_to_jax
from repro_torch.configs import get_config
from repro_torch.data import token_stream_batches
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.launch.shapes import frontend_shapes
from repro_torch.models.model import build_model
from repro_torch.tokenizer import HashWordTokenizer
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.optimizer import tree_leaves


def frontend_inputs(cfg, b: int, rng, device) -> dict:
    """The stub frontend's random inputs of ``b`` rows in the model dtype,
    shaped by ``shapes.frontend_shapes`` and drawn from ``rng`` in the
    reference's order."""
    return {name: torch.as_tensor(rng.standard_normal(shape)).to(
                device=device, dtype=torch_dtype(cfg.dtype))
            for name, shape in frontend_shapes(cfg, b).items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
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
    if cfg.family in ("audio", "encdec", "vlm"):
        print(f"note: {args.arch} takes stub multimodal inputs; training on "
              "text-token stream with random frontend embeddings")
    model = build_model(cfg)
    tok = HashWordTokenizer(cfg.vocab_size)
    # seed: ok CLI smoke trainer, deterministic init
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M seq={args.seq} "
          f"batch={args.batch}")

    opt_cfg = AdamWConfig(lr=args.lr)
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              total_steps=args.steps)
    opt = init_opt_state(params)
    stream = token_stream_batches(tok, args.batch, args.seq)

    rng = np.random.default_rng(0)
    t0 = time.time()
    first = last = None
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v).to(device) for k, v in next(stream).items()}
        batch.update(frontend_inputs(cfg, args.batch, rng, device))
        params, opt, metrics = step_fn(params, opt, batch)
        last = metrics["loss"]          # a 0-d tensor, read only where printed
        if first is None:
            first = float(last)
        if step % args.log_every == 0 or step == args.steps - 1:
            tps = args.batch * args.seq * (step + 1) / (time.time() - t0)
            print(f"step {step:4d} loss {float(last):.4f} tok/s {tps:,.0f}")
    last = float(last)
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.steps, torch_params_to_jax(params, cfg),
                               {"arch": args.arch}, dtypes=torch_param_dtypes(params, cfg))
        print("checkpoint:", path)
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
