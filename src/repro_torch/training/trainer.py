"""Training step builders: plain and gradient-accumulation (microbatched).

Counterpart of ``src/repro/training/trainer.py``.  ``make_train_step``
returns ``train_step(params, opt_state, batch) -> (params, opt_state,
metrics)``, which updates the parameter tree in place (``adamw_update``)
and returns it for the reference's calling convention.  With
``microbatches > 1`` the batch axis is split and the gradients accumulate in
fp32, the memory lever of the reference.  A step reads one host scalar, the
loss (``metrics["loss"]`` is a float), as the reference's caller reads it.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model

from .optimizer import AdamWConfig, adamw_update, cosine_schedule, tree_leaves, tree_map


def _like(params, leaves):
    """A tree shaped as ``params`` holding ``leaves`` (one per leaf of
    ``params``, in ``tree_leaves`` order)."""
    by_leaf = {id(p): x for p, x in zip(tree_leaves(params), leaves)}
    return tree_map(lambda p: by_leaf[id(p)], params)


def value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads) of ``model.loss`` at ``params`` on ``batch``;
    ``grads`` is shaped as ``params``, each leaf in its parameter's dtype.
    Every parameter of the stack reaches the loss, so a leaf without a
    gradient raises (autograd's unused-input error): a kernel whose output
    dropped out of the graph cannot train silently."""
    leaves = tree_leaves(params)
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, _like(params, grads)


def microbatch_value_and_grad(model: Model, params, batch, microbatches: int):
    """(loss, grads) of ``batch`` split into ``microbatches`` along the batch
    axis: each part's gradients accumulated in fp32, the sums and the loss
    divided by ``microbatches`` (the reference's ``scan``).  ``grads`` is
    shaped as ``params`` with fp32 leaves."""
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
    n = b // microbatches
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree_leaves(params)]
    loss = torch.zeros((), dtype=torch.float32, device=acc[0].device)
    for i in range(microbatches):
        micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        l, _, g = value_and_grad(model, params, micro)
        for a, gi in zip(acc, tree_leaves(g)):
            a.add_(gi)
        loss = loss + l
    return loss / microbatches, _like(params, [a.div_(microbatches) for a in acc])


def make_train_step(model: Model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    warmup: int = 100, total_steps: int = 10_000):
    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(model, params, batch)
        else:
            loss, grads = microbatch_value_and_grad(model, params, batch, microbatches)
            metrics = {}
        lr_scale = cosine_schedule(opt_state["step"], warmup=warmup, total=total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg,
                                         lr_scale=float(lr_scale))
        metrics = dict(metrics)
        metrics["loss"] = loss.item()
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: Model):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}
    return eval_step
