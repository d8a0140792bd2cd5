"""Placement rules of the reference's production meshes, as pure functions
(counterpart of ``src/repro/launch/sharding.py``).

2D FSDP x TP: weight matrices shard over both "data" (FSDP) and "model"
(TP); attention shards heads over "model" when the head count divides the
axis, otherwise the embedding dim (row parallel), checked per tensor.  KV
caches shard the batch over ("pod", "data") and the sequence over "model".
The port runs one card, so nothing here places a tensor or issues a
collective: the rules say what each device of the reference's mesh would
hold, and :func:`per_device_bytes` adds it up for the dry-run.

A spec is a tuple with one entry per dim, each an axis name, a tuple of
names or None (the reference's ``PartitionSpec`` as a tuple; ``()`` is
replicated).  Trees are flat ``{path: Leaf}`` dicts keyed by the
reference's path names (``scan/0/attn/w_q``, ``m/embed``, ``scan/0/k``),
because the rules read those names and the reference's layout: its layers
stacked under ``scan/<j>`` (a leading period axis that no spec shards), its
attention weights split into ``w_q``/``w_k``/``w_v``.  :func:`param_leaves`,
:func:`opt_state_leaves` and :func:`cache_leaves` build them from the port's
trees without reading a value.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.checkpoint.convert import jax_leaf_shapes
from repro_torch.models.config import ModelConfig

from .mesh import batch_axes


class Leaf(NamedTuple):
    """A leaf's shape and dtype, what the placement rules read."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


# ------------------------------------------------------------------ trees

def param_leaves(params, cfg: ModelConfig) -> Dict[str, Leaf]:
    """The port's parameters in the reference's layout and path names."""
    return {k: Leaf(*v) for k, v in jax_leaf_shapes(params, cfg).items()}


def opt_state_leaves(p_leaves: Dict[str, Leaf]) -> Dict[str, Leaf]:
    """AdamW's state (``training.optimizer.init_opt_state``): fp32 ``m`` and
    ``v`` shaped as each parameter, and the step, an int32 scalar in the
    reference (a host int in the port)."""
    out = {f"{part}/{k}": Leaf(leaf.shape, torch.float32)
           for part in ("m", "v") for k, leaf in p_leaves.items()}
    out["step"] = Leaf((), torch.int32)
    return out


def cache_leaves(caches) -> Dict[str, Leaf]:
    """The port's decode caches (``Model.init_caches``) in the reference's
    layout.  The reference also keeps an int32 ``pos`` in every KV entry
    (stacked over the periods of a ``scan`` entry) and at the top; the port
    keeps one host-int ``pos`` at the top, so those leaves are added here as
    the reference holds them."""
    def entry(prefix, e, stacked):
        out = {f"{prefix}/{k}": Leaf(tuple(t.shape), t.dtype) for k, t in e.items()}
        if "k" in e:
            lead = (e["k"].shape[0],) if stacked else ()
            out[f"{prefix}/pos"] = Leaf(lead, torch.int32)
        return dict(sorted(out.items()))

    out = {}
    if "scan" in caches:
        for j, e in enumerate(caches["scan"]):
            out.update(entry(f"scan/{j}", e, True))
        for i, e in enumerate(caches["rem"]):
            out.update(entry(f"rem/{i}", e, False))
    else:
        out.update(entry("self", caches["self"], True))
        for name in ("cross_k", "cross_v"):
            out[name] = Leaf(tuple(caches[name].shape), caches[name].dtype)
    out["pos"] = Leaf((), torch.int32)
    return out


def tensor_leaves(tree: dict) -> Dict[str, Leaf]:
    """{name: Leaf} of a flat dict of tensors (a batch, a token)."""
    return {k: Leaf(tuple(t.shape), t.dtype) for k, t in tree.items()}


# ------------------------------------------------------------------ rules

def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def best_spec(mesh, shape, candidates) -> tuple:
    """The first candidate whose named axes divide the dims, padded with
    None to the rank; else replicated."""
    for cand in candidates:
        cand = tuple(cand) + (None,) * (len(shape) - len(cand))
        if all(axis is None or dim % _axis_size(mesh, axis) == 0
               for dim, axis in zip(shape, cand)):
            return cand
    return ()


def _scanned(pathstr: str) -> bool:
    """Stacked over layers: ``scan/``, ``enc_scan/``, ``dec_scan/``."""
    return pathstr.startswith("scan/") or "_scan/" in pathstr


def _param_spec(mesh, pathstr: str, shape, mode: str = "train") -> tuple:
    """The spec of one parameter, by its reference path and shape."""
    mdl, dat = "model", "data"
    name = pathstr.split("/")[-1]
    scanned = _scanned(pathstr)
    core = shape[1:] if scanned else shape

    def wrap(spec):
        return (None, *spec) if scanned else spec

    def best(cands):
        return wrap(best_spec(mesh, core, cands))

    if name == "embed":
        return best([(mdl, dat), (mdl, None), (None, mdl)])
    if name == "lm_head":
        return best([(dat, mdl), (None, mdl)])
    if name == "frontend_proj":
        return best([(None, mdl)])
    if name in ("w_q", "w_k", "w_v"):                       # (d, H, dh)
        return best([(dat, mdl, None), ((dat, mdl), None, None), (mdl, None, None)])
    if name == "w_o" and len(core) == 3:                    # (H, dh, d)
        return best([(mdl, None, dat), (None, None, (dat, mdl)), (None, None, mdl)])
    if name in ("b_q", "b_k", "b_v"):                       # (H, dh)
        return best([(mdl, None)])
    if name in ("w_gate", "w_up"):
        if len(core) == 3:                                  # MoE experts (E, d, f)
            cands = ([(dat, mdl, None), (mdl, dat, None)] if mode == "serve"
                     else [(mdl, dat, None)]) + [(mdl, None, None)]
            return best(cands)
        return best([(dat, mdl), (None, mdl), (mdl, None)])
    if name == "w_down":
        if len(core) == 3:                                  # MoE (E, f, d)
            cands = ([(dat, None, mdl), (mdl, None, dat)] if mode == "serve"
                     else [(mdl, None, dat)]) + [(mdl, None, None)]
            return best(cands)
        return best([(mdl, dat), (mdl, None), (None, dat)])
    if name == "router":                                    # (d, E)
        return best([(dat, mdl), (None, mdl)])
    if name == "w_in":                                      # mamba (d, big)
        return best([(dat, mdl), (mdl, None)])
    if name in ("w_y", "w_x"):                              # rglru (d, w)
        return best([(dat, mdl), (None, mdl), (mdl, None)])
    if name in ("w_a", "w_i"):                              # rglru (w, w)
        return best([(dat, mdl), (None, mdl)])
    if name == "w_out" or (name == "w_o" and len(core) == 2):   # (inner, d)
        return best([(mdl, dat), (mdl, None), (None, dat)])
    # norms, conv kernels, gates, scalars, score_head: replicated
    return wrap(())


def _strip_axis(spec: tuple, axis: str) -> tuple:
    out = []
    for entry in spec:
        if entry == axis:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a != axis)
            out.append(kept[0] if len(kept) == 1 else (kept or None))
        else:
            out.append(entry)
    return tuple(out)


def _is_expert(pathstr: str, leaf: Leaf) -> bool:
    name = pathstr.split("/")[-1]
    return (name in ("w_gate", "w_up", "w_down")
            and len(leaf.shape) >= (4 if pathstr.startswith("scan/") else 3))


SERVE_TP_ONLY_BYTES = 12 * 2 ** 30
"""Serve mode keeps weights TP-only when a model axis's share of the
non-expert weights is at most this (the reference's rule)."""


def param_specs(mesh, p_leaves: Dict[str, Leaf], mode: str = "train") -> Dict[str, tuple]:
    """mode "train": 2D FSDP x TP.  mode "serve": the same, then "data"
    stripped from every non-expert weight when those weights over the model
    axis come to at most 12 GiB a device (decode would re-gather FSDP shards
    every token); expert weights keep their expert-parallel placement."""
    specs = {k: _param_spec(mesh, k, leaf.shape, mode) for k, leaf in p_leaves.items()}
    if mode == "serve":
        nonexp = sum(leaf.nbytes for k, leaf in p_leaves.items() if not _is_expert(k, leaf))
        if nonexp / mesh.shape["model"] <= SERVE_TP_ONLY_BYTES:
            specs = {k: s if _is_expert(k, p_leaves[k]) else _strip_axis(s, "data")
                     for k, s in specs.items()}
    return specs


def opt_state_specs(mesh, p_specs: Dict[str, tuple]) -> Dict[str, tuple]:
    """``m`` and ``v`` placed as the parameters whose specs are given
    (the train specs under ZeRO-1), the step replicated."""
    out = {f"{part}/{k}": s for part in ("m", "v") for k, s in p_specs.items()}
    out["step"] = ()
    return out


def _batch_axis(mesh):
    ba = batch_axes(mesh)
    return ba if len(ba) > 1 else (ba[0] if ba else None)


def batch_spec(mesh, cfg: ModelConfig) -> Dict[str, tuple]:
    """Specs of a training or prefill batch's entries."""
    b = _batch_axis(mesh)
    out = {"tokens": (b, None), "targets": (b, None), "mask": (b, None)}
    if cfg.family in ("audio", "encdec"):
        out["frames"] = (b, None, None)
    if cfg.frontend == "vision_stub":
        out["prefix_embeds"] = (b, None, None)
    return out


def _cache_leaf_spec(mesh, name: str, shape, scanned: bool, batch_axis) -> tuple:
    mdl = "model"
    core = shape[1:] if scanned else shape
    if name in ("k", "v"):                 # (B, T, Hk, dh): batch, then sequence
        spec = best_spec(mesh, core, [(batch_axis, mdl, None, None),
                                      (batch_axis, None, None, None),
                                      (None, mdl, None, None)])
    elif name == "slot_pos":
        spec = best_spec(mesh, core, [(batch_axis, mdl), (batch_axis, None), (None, mdl)])
    elif name == "ssm":                    # (B, H, P, N)
        spec = best_spec(mesh, core, [(batch_axis, mdl, None, None),
                                      (batch_axis, None, None, None)])
    elif name == "h":                      # rglru (B, W)
        spec = best_spec(mesh, core, [(batch_axis, mdl), (batch_axis, None), (None, mdl)])
    elif name == "conv":                   # (B, w-1, C)
        spec = best_spec(mesh, core, [(batch_axis, None, mdl), (batch_axis, None, None)])
    else:                                  # pos
        spec = ()
    return (None, *spec) if scanned else spec


def cache_specs(mesh, c_leaves: Dict[str, Leaf], batch_size: int) -> Dict[str, tuple]:
    """Specs of :func:`cache_leaves`' tree, the decoder's layout (``scan``,
    ``rem``) or the encoder-decoder's (``self``, ``cross_k``/``cross_v``).
    A batch of 1 is not sharded; the sequence carries the model axis."""
    batch_axis = None if batch_size == 1 else _batch_axis(mesh)
    out = {}
    for path, leaf in c_leaves.items():
        parts = path.split("/")
        if path == "pos":
            out[path] = ()
        elif parts[0] in ("cross_k", "cross_v"):
            out[path] = (None, *best_spec(mesh, leaf.shape[1:],
                                          [(batch_axis, "model", None, None),
                                           (batch_axis, None, None, None),
                                           (None, "model", None, None)]))
        else:
            scanned = parts[0] in ("scan", "self")
            out[path] = _cache_leaf_spec(mesh, parts[-1], leaf.shape, scanned, batch_axis)
    return out


def token_spec(mesh, batch_size: int) -> tuple:
    ba = batch_axes(mesh)
    if batch_size == 1 or not ba:
        return (None,)
    return (ba if len(ba) > 1 else ba[0],)


# ------------------------------------------------------------------ bytes

def per_device_bytes(tree: Dict[str, Leaf], specs: Dict[str, tuple], mesh) -> int:
    """Bytes one device of ``mesh`` holds of ``tree`` placed by ``specs`` (a
    dim that its axes do not divide is padded up, as GSPMD pads)."""
    total = 0
    for k, leaf in tree.items():
        spec = tuple(specs[k]) + (None,) * (len(leaf.shape) - len(specs[k]))
        total += leaf.dtype.itemsize * math.prod(
            -(-dim // _axis_size(mesh, axis)) for dim, axis in zip(leaf.shape, spec))
    return total
