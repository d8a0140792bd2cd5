"""Meshes of the port (counterpart of ``src/repro/launch/mesh.py``).

Two kinds.  A :class:`NamedMesh` is a named shape and holds no devices: the
reference's production meshes, (16, 16) ("data", "model") and (2, 16, 16)
("pod", "data", "model"), on which the placement rules of
``launch.sharding`` and the dry-run reckon per-device bytes, as the
reference reads ``Mesh.shape[axis]``.  No collective is issued on it: one
process drives one card.

The device list of a row-sharded cache bank (``make_cache_mesh``): the
reference is single-controller, one process driving every shard of the
bank through ``shard_map``, and every replica of a group calls the same
bank object.  The port keeps that design, so that mesh is a tuple of torch
devices that one process drives, shard ``j`` on ``mesh[j]``, and not a
``torch.distributed`` process group.  The shards' replicated scalars (ring
pointer, clock, centroids, admission statistics) live on ``mesh[0]``, where
the queries of the serving engine are.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class NamedMesh:
    """A mesh as a named shape: ``axis_names`` in order and ``shape`` {axis:
    size}, read by the placement rules as the reference reads its ``Mesh``."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    @classmethod
    def of(cls, sizes, names) -> "NamedMesh":
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for axes {names}")
        return cls(tuple(names), dict(zip(names, (int(n) for n in sizes))))

    @property
    def name(self) -> str:
        """"16x16" or "2x16x16", the dry-run's file-name form."""
        return "x".join(str(self.shape[a]) for a in self.axis_names)


# The ambient mesh of ``models.sharding_utils.constrain`` and the log its
# resolved specs go to, set by ``use_mesh`` (the reference's
# ``jax.sharding.use_mesh``); nothing is ambient by default.
_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: NamedMesh, log: Optional[List[tuple]] = None):
    """Make ``mesh`` ambient in the block: ``sharding_utils.constrain`` then
    resolves its specs against it, appending ``(shape, spec)`` to ``log``
    when one is given."""
    token = _AMBIENT.set((mesh, log))
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def ambient_mesh() -> Optional[Tuple[NamedMesh, Optional[List[tuple]]]]:
    """(mesh, log) of the innermost ``use_mesh``, or None."""
    return _AMBIENT.get()


def make_production_mesh(*, multi_pod: bool = False) -> NamedMesh:
    """The reference's production mesh: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with ``multi_pod``."""
    if multi_pod:
        return NamedMesh.of((2, 16, 16), ("pod", "data", "model"))
    return NamedMesh.of((16, 16), ("data", "model"))


def make_host_mesh(model: int = 1) -> NamedMesh:
    """A ("data", "model") mesh over the CUDA devices present, ``model`` of
    them along "model"; raises when there are none or ``model`` does not
    divide their count (the reference asserts it)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0 or n % model:
        raise ValueError(f"a host mesh with model={model} needs a multiple of {model} "
                         f"CUDA devices, have {n}")
    return NamedMesh.of((n // model, model), ("data", "model"))


def batch_axes(mesh) -> tuple:
    """Mesh axes the batch dimension shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


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
