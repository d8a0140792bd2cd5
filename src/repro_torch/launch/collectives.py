"""Per-device collective bytes of a step on a mesh (counterpart of the
reference dry-run's ``collective_bytes``, ``src/repro/launch/dryrun.py``).

The reference parses the collectives out of the HLO that XLA's SPMD
partitioner emits.  The port has no partitioner: it reckons the collectives
that a PyTorch execution of the same placement issues, FSDP over the batch
axes ("pod", "data"), tensor parallelism over "model" and expert parallelism
for serve-mode MoE, from the specs of ``launch.sharding`` (``param_specs``,
``batch_spec``, ``cache_specs``, ``token_spec``) and the activations'
placement at the ``constrain`` sites of the models (``models/
sharding_utils.py``: the residual stream batch-sharded and whole over
"model", the logits' vocabulary over "model", a MoE block's dispatch groups
batch-sharded).  Nothing is traced or run: it is arithmetic on shapes.

Conventions (the reference's): bytes per device, by kind, named as its
``_COLL_RE`` names them; each collective counted at its RESULT shape (an
all-gather at the gathered size, a reduce-scatter at the shard, an
all-reduce and an all-to-all at the operand); a collective over a group of
one device moves nothing and is not counted.  Collectives inside the layer
loop (one pattern period of a stack; one encoder and one decoder layer of an
encoder-decoder) and, with more than one microbatch, inside the microbatch
loop are the loop's; ``collectives`` is the bytes outside the loops plus
``loop_trip_count`` times the loop's, with the reference's trip count
``max(pattern_periods, num_layers if enc_layers else 1, 1) *
max(microbatches, 1)``, and ``collectives_body_once`` counts the loop once.

The rules.  ``rows`` are the tokens one device holds of a microbatch (its
share of the batch, by ``batch_spec`` / ``token_spec``: the batch divided by
the batch axes when they divide it, else whole, times the sequence; 1 a row
in a decode step); activations are in the model's dtype, logits and
softmax statistics in fp32.

* FSDP (``param_specs``, mode "train").  A parameter whose spec carries a
  batch axis is all-gathered over those axes to its "model"-only placement
  before each use: once a microbatch in the forward, and again in the
  backward (FSDP frees the gathered copy after the forward; with
  ``cfg.remat`` the same gather serves the recompute).  Its gradient is
  reduce-scattered back to the shard.  A prefill or decode gathers once a
  step (mode "serve" strips "data" from the non-expert weights, so mostly
  nothing is gathered).
* Replicated parameters.  A parameter with no batch axis in its spec has its
  gradient all-reduced over the batch axes, at its own placement, each
  microbatch.
* Products over "model".  The residual stream is whole over "model" at every
  block boundary.  A product whose output dim carries "model" is
  column-parallel: nothing in the forward, and the all-reduce of its input's
  gradient in the backward (q, k, v, ``w_gate``, ``w_up``, ``w_in``,
  ``w_y``, ``w_x``, the head).  A product that contracts a "model"-sharded
  dim of a "model"-sharded input is row-parallel: its output is all-reduced
  (``w_o``'s heads, ``w_down``'s f, ``w_out``/``w_o``'s inner dim).  A
  weight whose contraction dim carries "model" while its input is whole
  (``w_k``/``w_v`` at ``(("data", "model"), None, None)`` when the KV heads
  do not divide the axis) is either gathered whole and used replicated, as
  Megatron replicates KV heads, or contracted on its local slice with the
  partial output all-reduced (and the input's gradient all-gathered): the
  one that moves fewer bytes, as a partitioner's cost model chooses.  An
  activation sharded over "model" that a whole-input consumer reads is
  all-gathered (a column-parallel ``w_o``'s output back into the residual
  stream; RG-LRU's x branch into its gates); the gather's gradient is a
  reduce-scatter where the consumer is itself column-parallel, else a
  slice.  With ``cfg.remat`` the backward repeats the forward's activation
  collectives.
* Mamba-2.  The mixer runs head-parallel on the states' placement (``ssm``
  by heads over "model"): z, x and dt by heads, B and C whole on every rank.
  ``w_in``'s output is one concatenated z/x/B/C/dt dim split evenly over
  "model", so the pieces a rank needs from its neighbours' shards move by
  collective-permute (and their gradients back); B's and C's gradients are
  partial over the heads (all-reduced in the backward), the gated RMSNorm
  sums over the whole inner dim (4 bytes a token), and ``w_out`` is
  row-parallel.  Where ``w_in``'s output is not sharded the mixer runs
  replicated and a decode step gathers its states whole.
* Attention.  Heads over "model" (the q, k and v specs) run locally.  With
  q's heads sharded and k/v replicated, the k and v gradients are partial
  sums over the q-head groups and are all-reduced in the backward.  A
  prefill writes K/V into caches whose sequence carries "model"
  (``cache_specs``): head-sharded K/V move to that layout all-to-all.  A
  decode step over such a cache runs split over the sequence: the new
  token's head-sharded k and v are all-gathered so that the slot's owner
  writes them, q's heads are all-gathered, each device attends over its
  share of the slots, and the partial outputs with their softmax statistics
  are all-reduced (``b x H x (dh + 2)`` fp32).  Recurrent states placed over
  "model" that a mixer reads whole (Mamba-2's, whose mixer runs replicated)
  are all-gathered each decode step.
* Vocabulary over "model".  The embedding lookup on a vocabulary-sharded
  table is vocab-parallel: its output is all-reduced.  The head is
  column-parallel over the vocabulary, and the reference's masked cross
  entropy (``models/transformer.py::cross_entropy``) reduces three fp32
  values a token over "model" (max, sum of exponentials, target logit); the
  loss is all-reduced over the batch axes.  A prefill's or decode's logits
  leave the step as they lie, the vocabulary over "model" (the reference's
  ``out_shardings=None`` leaves their placement to the partitioner, which
  gathers nothing).
* MoE.  The router's expert-sharded logits are gathered for the top-k (fp32)
  and the balance loss reduces its 2 x E statistics over the batch axes.
  Experts over "model" (mode "train") compute on the tokens every "model"
  rank holds, and the combined output is a partial sum over the experts:
  all-reduced in the forward, and the dispatch's gradient in the backward.
  Experts over "data" (serve mode) move their dispatched rows all-to-all,
  there and back: ``E x groups x capacity`` rows of the device's share of d.
* ``grad_sync_once`` (``launch/zero_trainer.py``).  Each data rank holds
  the whole parameters over the batch axes (ZeRO-0 with respect to data, as
  the zero trainer holds them; their "model" placement is serve mode's) and
  accumulates its fp32 gradients locally over its own batch, with no
  reduction over the batch axes inside the step; one all-reduce a batch axis
  of those gradients, plus one of the 4-byte loss, ends the step, exactly as
  the reference psums them.  On a mesh without a "model" axis the rules read
  one of size 1.
* ``zero1``.  Parameters in serve mode, the optimizer state in train mode;
  gradients reduce as above, and each parameter whose train spec carries a
  batch axis its serve spec lacks is all-gathered back after the update.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.device import torch_dtype
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import NamedMesh, batch_axes
from repro_torch.launch.shapes import abstract_params, decode_capacity
from repro_torch.models.config import ATTN, LOCAL_ATTN, MAMBA2, MOE, RGLRU, ModelConfig
from repro_torch.models.model import build_model
from repro_torch.models.moe import capacity

AG, AR, RS, A2A, PERMUTE = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                            "collective-permute")
KINDS = (AG, AR, RS, A2A, PERMUTE)
MODEL = "model"
F32 = 4


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _strip(spec: tuple, axes) -> tuple:
    out = []
    for entry in spec:
        kept = tuple(a for a in _axes(entry) if a not in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return tuple(out)


def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _nbytes(shape, itemsize: int, spec: tuple, mesh) -> int:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return itemsize * math.prod(-(-d // _size(mesh, _axes(a))) for d, a in zip(shape, spec))


def _moved(n: int, m: int, pieces) -> int:
    """Elements of an ``n``-wide dim split in ``m`` equal shards that the
    worst-placed rank needs from others, when it needs of each piece
    ``(start, length, split)`` its ``m``-th share (``split``) or all of it."""
    own = n // m
    worst = 0
    for j in range(m):
        need = have = 0
        for start, length, split in pieces:
            lo, hi = ((start + j * length // m, start + (j + 1) * length // m) if split
                      else (start, start + length))
            need += hi - lo
            have += max(0, min(hi, (j + 1) * own) - max(lo, j * own))
        worst = max(worst, need - have)
    return worst


def loop_trip_count(cfg: ModelConfig, microbatches: int) -> int:
    """The reference's scale of a loop body's collectives."""
    return max(cfg.pattern_periods, cfg.num_layers if cfg.enc_layers else 1, 1) * max(
        microbatches, 1)


def local_batch(batch: int, mesh) -> int:
    """Rows of the batch one device holds: split over the batch axes when
    they divide it (``batch_spec``, ``token_spec``), else whole."""
    n = _size(mesh, batch_axes(mesh))
    return batch // n if batch % n == 0 else batch


class _Weight:
    """One parameter of one layer: its shape and spec without the period
    axis, and the placement it is used at (``use``)."""

    def __init__(self, path, leaf, spec, mesh):
        stacked = path.startswith("scan/") or "_scan/" in path
        self.stacked = stacked
        self.layers = leaf.shape[0] if stacked else 1
        self.shape = leaf.shape[1:] if stacked else leaf.shape
        self.spec = tuple(spec[1:] if stacked else spec) + (None,) * (
            len(self.shape) - len(spec) + (1 if stacked else 0))
        self.itemsize = leaf.dtype.itemsize
        self.use = _strip(self.spec, batch_axes(mesh))
        parts = path.split("/")
        if "moe" in parts[:-1] and "dense" not in parts and len(self.shape) == 3:
            self.use = (self.spec[0],) + self.use[1:]   # experts stay on their ranks

    def model_dim(self) -> Optional[int]:
        for i, entry in enumerate(self.use):
            if MODEL in _axes(entry):
                return i
        return None


class _Reckoner:
    """One step's collectives, tallied where they run: ``layer`` (one pass
    of the layer loop), ``micro`` (a microbatch's own) and ``step`` (once a
    step)."""

    def __init__(self, cfg: ModelConfig, kind: str, seq: int, batch: int, mesh, microbatches: int,
                 zero1: bool, grad_sync_once: bool):
        if MODEL not in mesh.shape:     # a batch-only mesh: the rules read a "model" axis of 1
            mesh = NamedMesh(mesh.axis_names + (MODEL,), {**mesh.shape, MODEL: 1})
        self.cfg, self.kind, self.mesh = cfg, kind, mesh
        self.train = kind == "train"
        self.m = mesh.shape.get(MODEL, 1)
        self.b_axes = batch_axes(mesh)
        self.nb = _size(mesh, self.b_axes)
        self.a = torch_dtype(cfg.dtype).itemsize
        self.mb = max(microbatches, 1) if self.train else 1
        self.batch, self.seq = batch, seq
        self.b_loc = local_batch(batch, mesh)
        self.b_mb = max(self.b_loc // self.mb, 1)
        self.gso, self.zero1 = grad_sync_once and self.train, zero1 and self.train
        # the group of the step's own reductions over the batch axes: none in
        # the zero step, whose local step sees only its own rank's batch
        self.batch_group = 1 if self.gso else self.nb
        self.tally = {w: dict.fromkeys(KINDS, 0) for w in ("layer", "micro", "step")}
        leaves = shd.param_leaves(abstract_params(cfg), cfg)
        mode = "serve" if kind == "decode" or self.gso or self.zero1 else "train"
        specs = shd.param_specs(mesh, leaves, mode)
        self.train_specs = shd.param_specs(mesh, leaves, "train") if self.zero1 else None
        if self.gso:                    # the zero step holds its params whole over the batch axes
            specs = {k: _strip(v, self.b_axes) for k, v in specs.items()}
        self.w = {k: _Weight(k, leaf, specs[k], mesh) for k, leaf in leaves.items()}
        self.where = "micro"

    # -------------------------------------------------------------- tally

    def add(self, kind: str, nbytes, group: int, where: str = None) -> None:
        if group > 1 and nbytes:
            self.tally[where or self.where][kind] += int(nbytes)

    def act(self, kind: str, nbytes, group: int = None, *, fwd=True, bwd=False) -> None:
        """An activation collective over "model" (or ``group``): in the
        forward, in the backward, and again in the backward's recompute."""
        group = self.m if group is None else group
        if fwd:
            self.add(kind, nbytes, group)
            if self.train and self.cfg.remat:
                self.add(kind, nbytes, group)
        if bwd and self.train:
            self.add(kind, nbytes, group)

    # -------------------------------------------------------------- products

    def mm(self, path: str, x_sharded: bool, rows: int, n_in: int, n_out: int, *,
           in_dims=(0,), itemsize: int = None, grad_in: bool = True,
           expert_dim: int = None) -> bool:
        """x (rows x n_in) @ the weight at ``path``: the collectives of the
        product; returns whether the output is sharded over "model"."""
        w = self.w[path]
        a = itemsize or self.a
        md = w.model_dim()
        if md is None or md == expert_dim:                  # whole over "model"
            if x_sharded:
                self.act(AG, rows * n_in * a)
            return False
        if md not in in_dims:                               # column-parallel
            if x_sharded:
                self.act(AG, rows * n_in * a)
                self.act(RS, rows * n_in * a // self.m, fwd=False, bwd=grad_in)
            else:
                self.act(AR, rows * n_in * a, fwd=False, bwd=grad_in)
            return True
        if x_sharded:                                       # row-parallel
            self.act(AR, rows * n_out * a)
            return False
        # a whole input into a contraction-sharded weight: the cheaper of a
        # whole weight and a partial product
        gathers = 2 if self.train else 1
        whole = _nbytes(w.shape, w.itemsize, _strip(w.use, (MODEL,)), self.mesh)
        fsdp = _nbytes(w.shape, w.itemsize, w.use, self.mesh) if w.use != w.spec else 0
        partial = rows * a * (n_out + (n_in if self.train and grad_in else 0))
        if gathers * whole <= gathers * fsdp + partial:
            w.use = _strip(w.use, (MODEL,))
            return False
        self.act(AR, rows * n_out * a)
        self.act(AG, rows * n_in * a, fwd=False, bwd=grad_in)
        return False

    def to_whole(self, sharded: bool, rows: int, n: int, itemsize: int = None) -> bool:
        if sharded:
            self.act(AG, rows * n * (itemsize or self.a))
        return False

    # -------------------------------------------------------------- blocks

    def mlp(self, pfx: str, rows: int) -> None:
        d = self.cfg.d_model
        if pfx + "w_gate" in self.w:
            f = self.w[pfx + "w_gate"].shape[1]
            g = self.mm(pfx + "w_gate", False, rows, d, f)
            u = self.mm(pfx + "w_up", False, rows, d, f)
            if g != u:
                g = u = self.to_whole(True, rows, f)
        else:
            f = self.w[pfx + "w_up"].shape[1]
            u = self.mm(pfx + "w_up", False, rows, d, f)
        self.to_whole(self.mm(pfx + "w_down", u, rows, f, d), rows, d)

    def attention(self, pfx: str, rows: int, kv_rows: int = None, cache: str = None,
                  step: bool = False) -> None:
        """Self (or cross, ``kv_rows`` from the encoder) attention; ``cache``
        names the K/V cache leaf that a prefill writes or a decode step
        (``step``) reads."""
        d = self.cfg.d_model
        _, h, dh = self.w[pfx + "w_q"].shape
        hk = self.w[pfx + "w_k"].shape[1]
        q = self.mm(pfx + "w_q", False, rows, d, h * dh)
        cross_step = step and kv_rows == 0
        if cross_step:                  # a decode step's cross attention reads its cache
            k = self.w[pfx + "w_k"].model_dim() == 1
        else:
            kv_rows = rows if kv_rows is None else kv_rows
            k = self.mm(pfx + "w_k", False, kv_rows, d, hk * dh)
            self.mm(pfx + "w_v", False, kv_rows, d, hk * dh)
        seq_sharded = False
        if cache is not None:
            spec = self.cache_specs[cache]
            seq_sharded = MODEL in _axes(spec[-3]) if len(spec) >= 3 else False
        out = q
        if step and seq_sharded:        # split over the cache's sequence
            if k and not cross_step:
                self.act(AG, 2 * rows * hk * dh * self.a)
            if q:
                self.act(AG, rows * h * dh * self.a)
            self.act(AR, rows * h * (dh + 2) * F32)
            out = False
        elif not step:
            if q and not k:
                self.act(AR, 2 * kv_rows * hk * dh * self.a, fwd=False, bwd=True)
            elif k and not q:
                self.act(AG, 2 * kv_rows * hk * dh * self.a)
            if cache is not None and seq_sharded and k:
                self.add(A2A, 2 * kv_rows * hk * dh * self.a // self.m, self.m)
        self.to_whole(self.mm(pfx + "w_o", out, rows, h * dh, d, in_dims=(0, 1)), rows, d)

    def moe(self, pfx: str, rows: int) -> None:
        cfg, d = self.cfg, self.cfg.d_model
        e, f = cfg.num_experts, cfg.moe_d_ff
        self.to_whole(self.mm(pfx + "router", False, rows, d, e, itemsize=F32), rows, e, F32)
        if self.train:
            self.add(AR, 2 * e * F32, self.batch_group)
        n = self.b_mb_global * (rows // self.b_mb)       # tokens of the microbatch
        gsz = min(cfg.moe_group_size, n)
        groups = -(-n // gsz)
        g_loc = groups // self.nb if groups % self.nb == 0 else groups
        cap = capacity(cfg, gsz)
        ex_rows = e * g_loc * cap
        gate = self.w[pfx + "w_gate"]
        e_axes = _axes(gate.use[0])
        if MODEL in e_axes:                 # experts over "model": tokens on every rank
            self.act(AR, g_loc * gsz * d * self.a, bwd=True)
        else:
            ep = [a for a in e_axes if a in self.b_axes]
            d_sharded = gate.model_dim() == 1
            d_loc = d // self.m if d_sharded else d
            if ep:                          # experts over "data": dispatched all-to-all
                self.act(A2A, 2 * ex_rows * d_loc * self.a, _size(self.mesh, ep), bwd=True)
            rows_e = ex_rows
            h = self.mm(pfx + "w_gate", d_sharded, rows_e, d, f, in_dims=(1,), expert_dim=0)
            self.mm(pfx + "w_up", d_sharded, rows_e, d, f, in_dims=(1,), expert_dim=0)
            o = self.mm(pfx + "w_down", h, rows_e, f, d, in_dims=(1,), expert_dim=0)
            self.to_whole(o, g_loc * gsz, d)
        if cfg.moe_dense_residual:
            self.mlp(pfx + "dense/", rows)

    def mamba(self, pfx: str, rows: int, cache: str = None, step: bool = False) -> None:
        d, a = self.cfg.d_model, self.a
        big = self.w[pfx + "w_in"].shape[1]
        inner = self.w[pfx + "w_out"].shape[0]
        nh = self.w[pfx + "a_log"].shape[0]
        bc = big - 2 * inner - nh                      # B and C, shared by the heads
        if self.mm(pfx + "w_in", False, rows, d, big):
            # head-parallel mixer: z, x and dt by heads, B and C whole on every
            # rank; the pieces of w_in's output shard that another rank needs
            # move to it, and their gradients back
            pieces = ((0, inner, True), (inner, inner, True), (2 * inner, bc, False),
                      (2 * inner + bc, nh, True))
            self.act(PERMUTE, rows * _moved(big, self.m, pieces) * a, bwd=True)
            self.act(AR, rows * bc * a, fwd=False, bwd=True)   # B, C: partial over heads
            self.act(AR, rows * F32, bwd=True)                 # the gate norm's sum of squares
            heads = True
        else:
            heads = False
            if step:                    # a replicated mixer reads its states whole
                for name in ("ssm", "conv"):
                    leaf, spec = self.cache_leaves[cache + name], self.cache_specs[cache + name]
                    stacked = cache.startswith("scan/")
                    shape, spec = (leaf.shape[1:], spec[1:]) if stacked else (leaf.shape, spec)
                    if MODEL in [x for e in spec for x in _axes(e)]:
                        self.act(AG, _nbytes(shape, leaf.dtype.itemsize, _strip(spec, (MODEL,)),
                                             self.mesh))
        self.to_whole(self.mm(pfx + "w_out", heads, rows, inner, d), rows, d)

    def rglru(self, pfx: str, rows: int) -> None:
        d = self.cfg.d_model
        wd = self.w[pfx + "w_y"].shape[1]
        y = self.mm(pfx + "w_y", False, rows, d, wd)
        u = self.mm(pfx + "w_x", False, rows, d, wd)
        r = self.mm(pfx + "w_a", u, rows, wd, wd)
        # a column-parallel w_a gathered u whole: w_i reads that copy
        self.mm(pfx + "w_i", u and self.w[pfx + "w_a"].model_dim() == 0, rows, wd, wd)
        if y != r:
            y = r = self.to_whole(True, rows, wd)
        self.to_whole(self.mm(pfx + "w_o", r, rows, wd, d), rows, d)

    def block(self, kind: str, pfx: str, cache: str, rows: int, step: bool) -> None:
        if kind in (ATTN, LOCAL_ATTN, MOE):
            self.attention(pfx + "attn/", rows, cache=cache + "k" if cache is not None else None,
                           step=step)
            if kind == MOE:
                self.moe(pfx + "moe/", rows)
            else:
                self.mlp(pfx + "mlp/", rows)
        elif kind == MAMBA2:
            self.mamba(pfx + "mixer/", rows, cache, step)
        elif kind == RGLRU:
            self.rglru(pfx + "rec/", rows)
            self.mlp(pfx + "mlp/", rows)
        else:
            raise ValueError(kind)

    # -------------------------------------------------------------- the step

    def caches_of(self, batch: int, capacity: int) -> None:
        caches = build_model(self.cfg).init_caches(batch, capacity, "meta")
        self.cache_leaves = shd.cache_leaves(caches)
        self.cache_specs = shd.cache_specs(self.mesh, self.cache_leaves, batch)

    def run(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        cfg, kind, d = self.cfg, self.kind, self.cfg.d_model
        step = kind == "decode"
        s = 1 if step else self.seq
        self.b_mb_global = max(self.batch // self.mb, 1)
        prefix = cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else 0
        rows = self.b_mb * (s + (0 if step else prefix))
        if kind == "decode":
            self.caches_of(self.batch, decode_capacity(self.seq))
        elif kind == "prefill":
            self.caches_of(self.batch, decode_capacity(self.seq + cfg.num_prefix_tokens))
        writes = kind != "train"
        # the embedding lookup (vocabulary over "model": vocab-parallel)
        emb = self.w["embed"].model_dim()
        if emb == 0:
            self.act(AR, self.b_mb * s * d * self.a)
        elif emb == 1:
            self.act(AG, self.b_mb * s * d * self.a)
        if prefix and not step:
            self.to_whole(self.mm("frontend_proj", False, self.b_mb * prefix,
                                  cfg.frontend_dim, d, grad_in=False), self.b_mb * prefix, d)
        if cfg.enc_layers:
            self.encdec(rows, step)
        else:
            self.where = "layer"
            if cfg.pattern_periods:
                for j, bk in enumerate(cfg.block_pattern):
                    self.block(bk, f"scan/{j}/", f"scan/{j}/" if writes else None, rows, step)
            self.where = "micro"
            for i, bk in enumerate(cfg.pattern_remainder):
                self.block(bk, f"rem/{i}/", f"rem/{i}/" if writes else None, rows, step)
        self.head(rows if self.train else self.b_mb)
        self.params()
        return self.result()

    def encdec(self, rows: int, step: bool) -> None:
        cfg = self.cfg
        self.where = "layer"
        if not step:
            enc_rows = self.b_mb * cfg.enc_frames
            self.attention("enc_scan/attn/", enc_rows)
            self.mlp("enc_scan/mlp/", enc_rows)
        cache = None if self.train else "self/k"
        self.attention("dec_scan/self_attn/", rows, cache=cache, step=step)
        self.attention("dec_scan/cross_attn/", rows,
                       kv_rows=0 if step else self.b_mb * cfg.enc_frames,
                       cache=None if self.train else "cross_k", step=step)
        self.mlp("dec_scan/mlp/", rows)
        self.where = "micro"

    def head(self, rows: int) -> None:
        cfg, d = self.cfg, self.cfg.d_model
        v = cfg.padded_vocab
        if cfg.tie_embeddings:
            sharded = self.mm("embed", False, rows, d, v, in_dims=(1,))
        else:
            sharded = self.mm("lm_head", False, rows, d, v)
        if self.train:
            if sharded:
                self.act(AR, 3 * rows * F32)
            self.add(AR, F32, self.batch_group)

    def params(self) -> None:
        """The parameters' own collectives: FSDP gathers, gradient
        reductions, the zero steps' syncs."""
        decode = self.kind == "decode"
        for path, w in self.w.items():
            if decode and (path.startswith("enc_") or path == "frontend_proj"
                           or "cross_attn/w_k" in path or "cross_attn/w_v" in path
                           or "cross_attn/b_k" in path or "cross_attn/b_v" in path):
                continue
            self.where = "layer" if w.stacked else "micro"
            spec_axes = {a for e in w.spec for a in _axes(e)}
            use_axes = {a for e in w.use for a in _axes(e)}
            removed = tuple(a for a in self.mesh.axis_names if a in spec_axes - use_axes)
            shard = _nbytes(w.shape, w.itemsize, w.spec, self.mesh)
            gathered = _nbytes(w.shape, w.itemsize, w.use, self.mesh)
            if not self.train:
                self.add(AG, gathered, _size(self.mesh, removed))
                continue
            b_in = tuple(a for a in removed if a in self.b_axes)
            m_in = tuple(a for a in removed if a == MODEL)
            if self.gso:                # replicated over the batch axes: one sync a step
                for _ in range(2):
                    self.add(AG, gathered, _size(self.mesh, m_in))
                numel = w.layers * _nbytes(w.shape, 1, w.spec, self.mesh)
                for ax in self.b_axes:
                    self.add(AR, numel * F32, self.mesh.shape[ax], "step")
                continue
            for _ in range(2):
                self.add(AG, gathered, _size(self.mesh, removed))
            grad = _nbytes(w.shape, w.itemsize, _strip(w.spec, m_in), self.mesh)
            self.add(RS, grad, _size(self.mesh, b_in))
            rest = tuple(a for a in self.b_axes if a not in b_in)
            self.add(AR, grad, _size(self.mesh, rest))
            if self.zero1:
                t_spec = self.train_specs[path]
                t_spec = t_spec[1:] if w.stacked else t_spec
                extra = {a for e in t_spec for a in _axes(e) if a in self.b_axes} - spec_axes
                self.add(AG, w.layers * shard, _size(self.mesh, tuple(extra)), "step")
        if self.gso:
            self.add(AR, F32, self.mesh.shape[self.b_axes[0]] if self.b_axes else 1, "step")

    def result(self):
        """(outside the loops, one pass of the loop body): a microbatch's own
        collectives are the loop's when there is a microbatch loop."""
        layer, micro, step = (self.tally[k] for k in ("layer", "micro", "step"))
        loop = {k: layer[k] + (micro[k] if self.mb > 1 else 0) for k in KINDS}
        outside = {k: step[k] + (0 if self.mb > 1 else micro[k]) for k in KINDS}
        return outside, loop


def collective_bytes(cfg: ModelConfig, kind: str, seq: int, batch: int, mesh, *,
                     microbatches: int, zero1: bool = False, grad_sync_once: bool = False):
    """``(collectives, collectives_body_once, loop_trip_count)`` of one step
    of ``kind`` ("train", "prefill", "decode") at ``seq`` x ``batch`` (the
    global batch) on ``mesh``: bytes per device by kind, as the reference's
    dry-run records them.  ``microbatches`` is the train step's (clipped as
    ``dryrun.clip_microbatches`` clips it); prefill and decode take 1."""
    outside, loop, trips = split(cfg, kind, seq, batch, mesh, microbatches=microbatches,
                                 zero1=zero1, grad_sync_once=grad_sync_once)
    full = {k: outside[k] + trips * loop[k] for k in KINDS if outside[k] or loop[k]}
    once = {k: outside[k] + loop[k] for k in KINDS if outside[k] or loop[k]}
    return full, once, trips


def split(cfg: ModelConfig, kind: str, seq: int, batch: int, mesh, *, microbatches: int,
          zero1: bool = False, grad_sync_once: bool = False):
    """(bytes outside the loops, bytes of one pass of the loop body, trips),
    each by kind: ``collectives == outside + trips * loop``."""
    r = _Reckoner(cfg, kind, seq, batch, mesh, microbatches, zero1, grad_sync_once)
    outside, loop = r.run()
    return outside, loop, loop_trip_count(cfg, r.mb)
