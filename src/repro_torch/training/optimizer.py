"""AdamW written out (counterpart of ``src/repro/training/optimizer.py``).

The reference's recipe, which ``torch.optim.AdamW`` does not follow: fp32
moments whatever the parameter dtype; one clip by the global norm of ALL
gradient leaves; bias correction in fp32 from an integer step; weight decay
added to the update before ``lr`` scales it; the new value cast back to the
parameter's dtype.

Parameters are the port's plain trees (dicts and lists of tensors).  The
update runs under ``torch.no_grad()`` and writes parameters and moments in
place; it returns the tree and the state for the reference's calling
convention.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def tree_leaves(tree):
    """The tensors of a tree of dicts and lists, dict keys in sorted order
    (``jax.tree.leaves``' order over the same keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_opt_state(params):
    """Zero fp32 moments shaped as ``params``; ``step`` is a host int."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": 0}


def global_norm(tree):
    """sqrt of the summed squares of every leaf, in fp32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def adamw_update(params, grads, opt_state, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step of ``params`` by ``grads`` (same tree), in place.
    ``lr_scale`` is a float or a 0-d tensor (``cosine_schedule``).
    Returns ``(params, opt_state)``."""
    step = opt_state["step"] + 1
    gn = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    # fp32 bias corrections, as the reference's b ** float32(step)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))
    lr = cfg.lr * lr_scale
    with torch.no_grad():
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
            g = g.float() * clip
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
            p32 = p.float()
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p32
            p.copy_((p32 - lr * delta).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state


def cosine_schedule(step, *, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to 1, then a cosine from 1 down to ``floor`` at
    ``total``; a float32 tensor of ``step``'s shape."""
    s = torch.as_tensor(step).float()
    warm = (s + 1.0) / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)


def train_loop(params, opt_state, cfg: AdamWConfig, loss_fn, model_cfg, batches):
    """One AdamW step in place per tuple ``args`` of ``batches``: the loss
    ``loss_fn(params, model_cfg, *args)``, its gradients by ``backward``,
    then ``adamw_update``.  The leaves require grad only meanwhile.  Returns
    the losses as floats (one host read a step, as the reference reads
    each)."""
    leaves = tree_leaves(params)
    losses = []
    try:
        for p in leaves:
            p.requires_grad_(True)
        for args in batches:
            loss = loss_fn(params, model_cfg, *args)
            loss.backward()
            grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                             params)
            adamw_update(params, grads, opt_state, cfg)
            for p in leaves:
                p.grad = None
            losses.append(loss.item())
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return losses
