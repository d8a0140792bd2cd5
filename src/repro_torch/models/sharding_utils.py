"""Mesh-aware sharding constraints (counterpart of
``src/repro/models/sharding_utils.py``).

``constrain(x, *spec)`` marks where the reference seeds GSPMD with a
placement: batch-sharded activations after the embedding gather, the
logits' vocabulary over "model", a MoE block's dispatch groups.  The
reference applies ``with_sharding_constraint`` for the axes that exist in
the ambient mesh and divide the dimension.  The port runs one process on
one card, so there is nothing to constrain: ``constrain`` returns ``x``
unchanged, and under ``launch.mesh.use_mesh(mesh, log)`` it appends the
spec the reference would apply, ``(shape, resolve(shape, *spec,
mesh=mesh))``, to ``log``.

The BATCH sentinel expands to ('pod', 'data') or 'data', as available.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.launch import mesh as mesh_lib

BATCH = "__batch__"


def resolve(shape, *spec, mesh=None) -> Optional[Tuple]:
    """The spec the reference applies to an array of ``shape`` under
    ``mesh`` (a ``NamedMesh``; default the ambient one), padded with None to
    the rank; None off-mesh.  An axis absent from the mesh, or whose size
    does not divide the dimension, resolves to None."""
    if mesh is None:
        ambient = mesh_lib.ambient_mesh()
        mesh = ambient[0] if ambient is not None else None
    if mesh is None:
        return None
    axes = mesh.shape
    resolved = []
    for dim, a in zip(shape, spec):
        if a == BATCH:
            a = tuple(n for n in ("pod", "data") if n in axes) or None
            if isinstance(a, tuple) and len(a) == 1:
                a = a[0]
        if a is None:
            resolved.append(None)
            continue
        names = a if isinstance(a, tuple) else (a,)
        size = 1
        for n in names:
            size = size * axes[n] if n in axes else 0
        resolved.append(a if size and dim % size == 0 else None)
    return tuple(resolved + [None] * (len(shape) - len(resolved)))


def constrain(x, *spec):
    """``x`` unchanged; under ``use_mesh(mesh, log)`` the reference's spec
    for it goes to ``log``."""
    ambient = mesh_lib.ambient_mesh()
    if ambient is not None and ambient[1] is not None:
        shape = tuple(x.shape)
        ambient[1].append((shape, resolve(shape, *spec, mesh=ambient[0])))
    return x
