"""Gradient-accumulation train step with one gradient sync a step
(counterpart of ``src/repro/launch/zero_trainer.py``).

Microbatched accumulation under a framework that reduces per backward
re-syncs the gradients over the data axis on every microbatch.  Here each
data rank accumulates its LOCAL fp32 gradients over its microbatches
(``trainer.microbatch_value_and_grad``), and ONE all-reduce a step
averages them, with the loss, as a single flat fp32 bucket: collective
volume drops from microbatches x params to 1 x params (the reference's
single ``pmean`` point).  Then the reference's ``cosine_schedule`` and
AdamW update the replicated parameters in place.

The data group is a ``torch.distributed`` process group (one process per
rank).  Its ``all_reduce`` sums (gloo has no average) and the bucket is
divided by the world size.  ``group=None`` is one process with nothing to
reduce: the step then equals ``make_train_step(microbatches=)``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update, cosine_schedule,
                                            tree_leaves)
from repro_torch.training.trainer import microbatch_value_and_grad

def make_zero_train_step(model: Model, opt_cfg: AdamWConfig, group=None, *,
                         microbatches: int, warmup: int = 100, total_steps: int = 10_000):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss"})``;
    ``batch`` is this rank's shard of the global batch."""

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        sizes = [p.numel() for p in leaves]
        # the gradients accumulate straight into the bucket's views; the
        # loss rides in its last element
        bucket = torch.zeros(sum(sizes) + 1, dtype=torch.float32, device=leaves[0].device)
        views = [v.view(p.shape) for v, p in zip(bucket[:-1].split(sizes), leaves)]
        loss, grads = microbatch_value_and_grad(model, params, batch, microbatches, out=views)
        bucket[-1] = loss
        if group is not None:
            # THE one synchronisation point per step
            dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
            bucket /= dist.get_world_size(group)
        lr_scale = cosine_schedule(opt_state["step"], warmup=warmup, total=total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg,
                                         lr_scale=lr_scale)
        return params, opt_state, {"loss": bucket[-1]}

    return step
