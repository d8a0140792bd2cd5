"""The assigned input shapes and their stand-ins for the dry-run
(counterpart of ``src/repro/launch/shapes.py``).

The reference builds ``jax.ShapeDtypeStruct`` stand-ins; the port builds
tensors on ``torch.device("meta")``, which carry a shape and a dtype and no
storage, so a step traced over them allocates nothing.  The same functions
take a real device (the dry-run's run on the card).

The dense caches' ``pos`` is a host int in the port and an int32 array in
the reference (``launch.sharding.cache_leaves`` adds the reference's).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model

META = torch.device("meta")

INPUT_SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def frontend_shapes(cfg: ModelConfig, batch: int) -> Dict[str, tuple]:
    """The stub frontend's inputs of ``batch`` rows, each in the model dtype:
    ``frames`` (B, F, d) for an audio or encoder-decoder id,
    ``prefix_embeds`` (B, P, frontend_dim) for a vision stub, none for a
    text-only stack.  The dry-run's stand-ins and the train CLI's random
    inputs (``launch.train.frontend_inputs``) both follow it."""
    out = {}
    if cfg.family in ("audio", "encdec"):
        out["frames"] = (batch, cfg.enc_frames, cfg.d_model)
    if cfg.frontend == "vision_stub":
        out["prefix_embeds"] = (batch, cfg.num_prefix_tokens, cfg.frontend_dim)
    return out


def _frontend(cfg: ModelConfig, batch: int, device) -> dict:
    dt = torch_dtype(cfg.dtype)
    return {k: torch.empty(s, dtype=dt, device=device)
            for k, s in frontend_shapes(cfg, batch).items()}


def train_inputs(cfg: ModelConfig, seq: int, batch: int, device=META) -> dict:
    """A training batch: int32 tokens and targets, an fp32 mask, and the
    frontend's inputs (uninitialised off the meta device)."""
    out = {"tokens": torch.empty((batch, seq), dtype=torch.int32, device=device),
           "targets": torch.empty((batch, seq), dtype=torch.int32, device=device),
           "mask": torch.empty((batch, seq), dtype=torch.float32, device=device)}
    out.update(_frontend(cfg, batch, device))
    return out


def prefill_inputs(cfg: ModelConfig, seq: int, batch: int, device=META) -> dict:
    out = {"tokens": torch.empty((batch, seq), dtype=torch.int32, device=device)}
    out.update(_frontend(cfg, batch, device))
    return out


def decode_capacity(seq: int) -> int:
    """Cache capacity: ``seq`` + decode slack, padded so the 16-way model
    axis divides the sequence dim (otherwise KV caches lose their sequence
    sharding)."""
    return ((seq + 8 + 255) // 256) * 256


def decode_inputs(cfg: ModelConfig, seq: int, batch: int, device=META) -> dict:
    """A token of each row and zero caches sized for a ``seq``-long context
    (``Model.init_caches``)."""
    caches = build_model(cfg).init_caches(batch, decode_capacity(seq), device)
    return {"token": torch.empty((batch,), dtype=torch.int32, device=device),
            "caches": caches}


def abstract_params(cfg: ModelConfig, device=META):
    """The parameter tree of ``cfg`` on ``device`` (no draws on meta)."""
    return build_model(cfg).init(None, device)


def make_step_fn(cfg: ModelConfig, kind: str, *, with_optimizer: bool = True,
                 microbatches: int = 1):
    """The step of ``kind``: ``train`` ``(params, opt_state, batch) ->
    (params, opt_state, metrics)`` (or ``(params, batch) -> loss`` without
    the optimizer), ``prefill`` ``(params, batch) -> (logits, caches)`` at
    the prompt's capacity, ``decode`` ``(params, token, caches) -> (logits,
    caches)``."""
    model = build_model(cfg)
    if kind == "train":
        if with_optimizer:
            from repro_torch.training import AdamWConfig, make_train_step
            return make_train_step(model, AdamWConfig(), microbatches=microbatches)

        def loss_step(params, batch):
            return model.loss(params, batch)[0]
        return loss_step
    if kind == "prefill":
        def prefill_step(params, batch):
            # the prompt (with a frontend's prefix) + decode slack, padded
            cap = decode_capacity(batch["tokens"].shape[1] + cfg.num_prefix_tokens)
            return model.prefill(params, batch, cap)
        return prefill_step
    if kind == "decode":
        def serve_step(params, token, caches):
            return model.decode_step(params, token, caches)
        return serve_step
    raise ValueError(kind)
