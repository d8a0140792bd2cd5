"""The device list a row-sharded cache bank runs on (counterpart of
``src/repro/launch/mesh.py::make_cache_mesh``).

The reference is single-controller: one process drives every shard of the
bank through ``shard_map``, and every replica of a group calls the same
bank object.  The port keeps that design, so its mesh is a tuple of torch
devices that one process drives, shard ``j`` on ``mesh[j]``, and not a
``torch.distributed`` process group.  The shards' replicated scalars (ring
pointer, clock, centroids, admission statistics) live on ``mesh[0]``, where
the queries of the serving engine are.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def make_cache_mesh(n_shards: int, devices: Optional[Sequence] = None
                    ) -> Tuple[torch.device, ...]:
    """``n_shards`` devices for a row-sharded bank.

    By default the first ``n_shards`` CUDA devices; it raises when fewer
    exist, as the reference raises.  A caller may name the devices instead
    (``devices``, one per shard), and may repeat one: ``["cpu"] * 4`` runs
    four shards on the CPU, ``["cuda:0"] * 4`` four on one card.  Nothing
    here repeats a device the caller did not name.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_shards:
            raise ValueError(f"a {n_shards}-shard cache mesh needs {n_shards} CUDA "
                             f"devices, have {have} (pass devices= to place shards "
                             f"explicitly)")
        return tuple(torch.device("cuda", i) for i in range(n_shards))
    mesh = tuple(torch.device(d) for d in devices)
    if len(mesh) != n_shards:
        raise ValueError(f"{len(mesh)} devices for {n_shards} shards")
    return mesh
