"""Kernel calls on meta tensors: the work they stand for, for the dry-run.

A meta tensor has a shape and a dtype and no values.  A kernel entry given
one returns an empty meta output of the kernel's shape and dtype and adds
the kernel's floating-point work to :data:`flops`, which the dry-run
(``launch.dryrun``) reads beside ``torch.utils.flop_counter``'s count of
the aten products.  Nothing is computed or launched; it is not a fallback,
since there are no values to compute.
"""
from __future__ import annotations

import numpy as np
import torch

flops = 0
"""Kernel work added by meta calls since the last reset."""


# hostsync: ok meta-device FLOP tally, host ints
def output(like: torch.Tensor, work: int) -> torch.Tensor:
    """An empty meta tensor shaped as ``like``, after adding ``work``."""
    global flops
    flops += int(work)
    return torch.empty_like(like)


# hostsync: ok meta-device FLOP tally, host ints
def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a position mask allows when the queries sit at
    the last ``sq`` of the ``sk`` key positions (a prefill: sq == sk; a
    suffix over a stored prefix), read from the shapes alone since meta
    positions have no values: causal keeps ``k <= q``, a window ``k > q -
    window``."""
    q = np.arange(sk - sq, sk, dtype=np.int64)
    hi = q if causal else np.full_like(q, sk - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros_like(q)
    return int(np.maximum(hi - lo + 1, 0).sum())
