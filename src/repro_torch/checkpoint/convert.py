"""Convert the JAX package's parameters, flattened to numpy, into the port's.

The input is ``{path: array}`` keyed as ``checkpoint.read_checkpoint`` (and
the JAX package's own ``_flatten``) key them.  Two layouts are understood:

* the decoder LM of ``repro.models.transformer``: the layers at pattern
  position j stacked over the periods under ``scan/<j>/...``, remainder
  layer i under ``rem/<i>/...`` (unstacked), with ``embed``, ``final_norm``
  and ``lm_head``; the port's ``layers`` list them in the reference's layer
  order (``transformer.layer_slots``);
* the encoder-decoder of ``repro.models.encdec``: encoder layers stacked
  under ``enc_scan/...`` (``norm1``, ``attn``, ``norm2``, ``mlp``), decoder
  layers under ``dec_scan/...`` (``norm1``, ``self_attn``, ``norm2``,
  ``cross_attn``, ``norm3``, ``mlp``), with ``embed`` (the tied head),
  ``enc_norm`` and ``final_norm``; the port lists them in ``enc_layers`` and
  ``dec_layers``.  A frontend LM's ``frontend_proj`` (frontend_dim, d) is
  carried as it is;
* the embedder of ``repro.models.embedder``: layers stacked under
  ``scan/...``; the reranker of ``repro.models.reranker`` is that layout
  plus an fp32 ``score_head`` (d, 1).

Attention weights come as ``w_q``/``w_k``/``w_v`` (d,h,dh) and ``w_o``
(h,dh,d) and become ``w_qkv`` (d,(H+2Hk)*dh) and ``w_o`` (H*dh,d); QKV
biases ``b_q``/``b_k``/``b_v`` (h,dh) become ``b_qkv`` ((H+2Hk)*dh,); a
swiglu MLP's ``w_gate``/``w_up`` become ``w_gate_up`` (d,2f), a gelu or
squared-ReLU MLP keeps ``w_up``/``w_down``.  A MOE block's ``moe/w_gate`` and
``moe/w_up`` (E,d,f) become ``w_gate_up`` (E,d,2f) beside ``w_down`` (E,f,d),
and Arctic's ``moe/dense`` is a swiglu MLP.  A MAMBA2 block's ``mixer/*``
and an RGLRU block's ``rec/*`` keep the reference's names and layouts
(``conv_w`` (C, W) included).  Norm parameters, the MoE ``router`` (d,E),
the SSM's ``a_log``, ``d_skip`` and ``dt_bias`` and the RG-LRU's ``w_a``,
``b_a``, ``w_i``, ``b_i`` and ``lam`` stay fp32; the other weights take the
config's dtype.

``torch_params_to_jax`` is the inverse for the decoder LM and the
encoder-decoder: it carries the
port's weights back to the reference's layout (``checkpoint.save_checkpoint``
writes them where the JAX package's ``load_checkpoint`` reads them).
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.config import MAMBA2, RGLRU, ModelConfig
from repro_torch.models.transformer import layer_slots

# leaves of the recurrent mixers that stay fp32 whatever the model dtype
FP32_LEAVES = {"mixer": ("a_log", "d_skip", "dt_bias"),
               "rec": ("w_a", "b_a", "w_i", "b_i", "lam")}
MIXER_LEAVES = {"mixer": ("w_in", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "w_out"),
                "rec": ("w_y", "w_x", "conv_w", "conv_b", "w_a", "b_a", "w_i", "b_i", "lam",
                        "w_o")}


def _f32(a: np.ndarray) -> np.ndarray:
    # bf16 leaves (ml_dtypes) have no torch counterpart through numpy
    return np.ascontiguousarray(a.astype(np.float32) if a.dtype.name == "bfloat16" else a)


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.tensor(_f32(a)).to(device=device, dtype=dtype)


def _mlp(w, key: str, mlp_type: str):
    """An MLP's numpy weights in the port's layout, read by ``w(name)``."""
    if mlp_type == "swiglu":
        p = {"w_gate_up": np.concatenate([w(key + "/w_gate"), w(key + "/w_up")], axis=-1)}
    else:
        p = {"w_up": w(key + "/w_up")}
    p["w_down"] = w(key + "/w_down")
    return p


def _attention(w, key: str, cfg: ModelConfig, device):
    """The attention weights under ``key`` (``attn``, ``self_attn`` or
    ``cross_attn``) in the port's layout."""
    dt = torch_dtype(cfg.dtype)
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    w_qkv = np.concatenate([w(f"{key}/w_q").reshape(d, h * dh),
                            w(f"{key}/w_k").reshape(d, hk * dh),
                            w(f"{key}/w_v").reshape(d, hk * dh)], axis=-1)
    attn = {"w_qkv": _tensor(w_qkv, dt, device),
            "w_o": _tensor(w(f"{key}/w_o").reshape(h * dh, d), dt, device)}
    if cfg.qkv_bias:
        attn["b_qkv"] = _tensor(np.concatenate(
            [w(f"{key}/b_q").reshape(-1), w(f"{key}/b_k").reshape(-1),
             w(f"{key}/b_v").reshape(-1)]), dt, device)
    return attn


def _norm_reader(w, has, device):
    return lambda key: {leaf: _tensor(w(f"{key}/{leaf}"), torch.float32, device)
                        for leaf in ("scale", "bias") if has(f"{key}/{leaf}")}


def _block(kind: str, w, has, cfg: ModelConfig, device):
    """One block in the port's layout; ``w(name)`` reads a leaf of the
    layer as numpy, ``has(name)`` says whether the checkpoint holds it."""
    dt = torch_dtype(cfg.dtype)
    norm = _norm_reader(w, has, device)
    layer = {"norm1": norm("norm1")}
    mixer = {MAMBA2: "mixer", RGLRU: "rec"}.get(kind)
    if mixer is not None:
        layer[mixer] = {leaf: _tensor(w(f"{mixer}/{leaf}"),
                                      torch.float32 if leaf in FP32_LEAVES[mixer] else dt,
                                      device) for leaf in MIXER_LEAVES[mixer]}
        if kind == MAMBA2:
            layer[mixer]["gate_norm"] = norm("mixer/gate_norm")
            return layer
    else:
        layer["attn"] = _attention(w, "attn", cfg, device)
    layer["norm2"] = norm("norm2")
    if has("moe/router"):
        moe = {k: _tensor(v, dt, device) for k, v in _mlp(w, "moe", "swiglu").items()}
        moe["router"] = _tensor(w("moe/router"), torch.float32, device)
        if has("moe/dense/w_gate"):
            moe["dense"] = {k: _tensor(v, dt, device)
                            for k, v in _mlp(w, "moe/dense", "swiglu").items()}
        layer["moe"] = moe
    else:
        layer["mlp"] = {k: _tensor(v, dt, device)
                        for k, v in _mlp(w, "mlp", cfg.mlp_type).items()}
    return layer


def _layer_readers(flat, cfg: ModelConfig):
    """(kind, w, has) of each layer in the port's order.  The decoder LM
    keeps pattern position j's layers stacked under ``scan/<j>/`` and
    remainder layer i under ``rem/<i>/``; the embedder and the reranker
    (one kind) stack every layer under ``scan/``."""
    if "scan/0/norm1/scale" not in flat:
        n = flat["scan/norm1/scale"].shape[0]
        if n != cfg.num_layers:
            raise ValueError(f"checkpoint has {n} layers, config {cfg.num_layers}")
        return [(cfg.block_pattern[0], lambda name, i=i: _f32(flat["scan/" + name][i]),
                 lambda name: "scan/" + name in flat) for i in range(n)]
    periods = flat["scan/0/norm1/scale"].shape[0]
    if periods != cfg.pattern_periods or any(f"rem/{i}/norm1/scale" not in flat
                                             for i in range(len(cfg.pattern_remainder))):
        raise ValueError(f"checkpoint has {periods} periods, config {cfg.pattern_periods} "
                         f"of {len(cfg.block_pattern)} and {len(cfg.pattern_remainder)} more")
    out = []
    for kind, group, j, index in layer_slots(cfg):
        pre = f"{group}/{j}/"
        read = ((lambda name, pre=pre: _f32(flat[pre + name])) if index is None else
                (lambda name, pre=pre, i=index: _f32(flat[pre + name][i])))
        out.append((kind, read, lambda name, pre=pre: pre + name in flat))
    return out


def _encdec_layers(flat, group: str, n: int, cfg: ModelConfig, device):
    """The layers stacked under ``enc_scan`` or ``dec_scan`` in the port's
    layout: an encoder layer's ``attn``, a decoder layer's ``self_attn`` and
    ``cross_attn``, the gelu MLP."""
    if flat[f"{group}/norm1/scale"].shape[0] != n:
        raise ValueError(f"checkpoint has {flat[f'{group}/norm1/scale'].shape[0]} "
                         f"{group} layers, config {n}")
    dt = torch_dtype(cfg.dtype)
    out = []
    for i in range(n):
        w = lambda name, i=i: _f32(flat[f"{group}/{name}"][i])
        norm = _norm_reader(w, lambda name: f"{group}/{name}" in flat, device)
        attns = ("attn",) if group == "enc_scan" else ("self_attn", "cross_attn")
        layer = {"norm1": norm("norm1")}
        for j, key in enumerate(attns):
            layer[key] = _attention(w, key, cfg, device)
            layer[f"norm{j + 2}"] = norm(f"norm{j + 2}")
        layer["mlp"] = {k: _tensor(v, dt, device)
                        for k, v in _mlp(w, "mlp", cfg.mlp_type).items()}
        out.append(layer)
    return out


def jax_params_to_torch(flat: Dict[str, np.ndarray], cfg: ModelConfig, device="cuda"):
    """Port parameters for ``cfg`` from a flattened JAX parameter tree, on
    ``device`` (the card unless the caller asks for ``"cpu"``)."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    norm = lambda key: {leaf: _tensor(flat[f"{key}/{leaf}"], torch.float32, device)
                        for leaf in ("scale", "bias") if f"{key}/{leaf}" in flat}
    params = {"embed": _tensor(flat["embed"], dt, device), "final_norm": norm("final_norm")}
    if "enc_scan/norm1/scale" in flat:          # the encoder-decoder (models.encdec)
        params["enc_norm"] = norm("enc_norm")
        params["enc_layers"] = _encdec_layers(flat, "enc_scan", cfg.enc_layers, cfg, device)
        params["dec_layers"] = _encdec_layers(flat, "dec_scan", cfg.num_layers, cfg, device)
        return params
    params["layers"] = [_block(kind, w, has, cfg, device)
                        for kind, w, has in _layer_readers(flat, cfg)]
    if "lm_head" in flat:
        params["lm_head"] = _tensor(flat["lm_head"], dt, device)
    if "frontend_proj" in flat:
        params["frontend_proj"] = _tensor(flat["frontend_proj"], dt, device)
    if "score_head" in flat:
        params["score_head"] = _tensor(flat["score_head"], torch.float32, device)
    return params


def jax_cache_state_to_torch(state_np: Dict[str, np.ndarray], cfg, device="cuda"):
    """The port's cache state from a JAX cache state of numpy arrays (IVF and
    admission keys included), on ``device`` (the card unless the caller asks
    for ``"cpu"``).  Keys, shapes and dtypes must be those of
    ``core.cache.init_cache(cfg)``.  The result is a local-layout state:
    ``core.distributed.shard_cache_state`` / ``shard_ivf_cache_state`` split
    it over a cache mesh."""
    from repro_torch.core.cache import init_cache
    device = resolve_device(device)
    want = init_cache(cfg, torch.device("meta"))
    if set(state_np) != set(want):
        raise ValueError(f"cache state keys differ: missing {sorted(set(want) - set(state_np))}, "
                         f"unexpected {sorted(set(state_np) - set(want))}")
    out = {}
    for key, ref in want.items():
        t = torch.from_numpy(np.array(state_np[key], copy=True))
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(f"cache state {key!r}: got {t.dtype} {tuple(t.shape)}, "
                             f"want {ref.dtype} {tuple(ref.shape)}")
        out[key] = t.to(device)
    return out


def _mlp_leaves(key: str, get, d_ff: int, mlp_type: str):
    """(path, tensor) of an MLP's weights under ``key``; ``get(name)`` reads
    one weight of the group's layers."""
    if mlp_type == "swiglu":
        gate_up = get("w_gate_up")
        out = [(key + "/w_gate", gate_up[..., :d_ff]), (key + "/w_up", gate_up[..., d_ff:])]
    else:
        out = [(key + "/w_up", get("w_up"))]
    return out + [(key + "/w_down", get("w_down"))]


def _attn_leaves(key: str, get, lead, cfg: ModelConfig):
    """(path, tensor) of the attention weights under ``key`` in the
    reference's layout; ``get(name)`` reads ``w_qkv``, ``w_o`` or ``b_qkv``
    with the leading dims ``lead``."""
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    wq, wk, wv = get("w_qkv").split([h * dh, hk * dh, hk * dh], dim=-1)
    out = [(f"{key}/w_q", wq.reshape(lead + (d, h, dh))),
           (f"{key}/w_k", wk.reshape(lead + (d, hk, dh))),
           (f"{key}/w_v", wv.reshape(lead + (d, hk, dh))),
           (f"{key}/w_o", get("w_o").reshape(lead + (h, dh, d)))]
    if cfg.qkv_bias:
        bq, bk, bv = get("b_qkv").split([h * dh, hk * dh, hk * dh], dim=-1)
        out += [(f"{key}/b_q", bq.reshape(lead + (h, dh))),
                (f"{key}/b_k", bk.reshape(lead + (hk, dh))),
                (f"{key}/b_v", bv.reshape(lead + (hk, dh)))]
    return out


def _stacked(layers, stacked: bool = True):
    """``leaf(*path)``: that leaf of every layer of ``layers``, stacked (or
    the one layer's, ``stacked`` False)."""
    def leaf(*path):
        get = lambda p: functools.reduce(dict.__getitem__, path, p).detach()
        return torch.stack([get(p) for p in layers]) if stacked else get(layers[0])
    return leaf


def _group_leaves(pre: str, kind: str, layers, stacked: bool, cfg: ModelConfig):
    """(path, tensor) of one group of layers of one kind under ``pre``:
    stacked over the layers (a pattern position) or the one layer's
    (``stacked`` False, a remainder layer)."""
    lead = (len(layers),) if stacked else ()
    leaf = _stacked(layers, stacked)

    first = layers[0]
    out = [(f"{pre}/norm1/{n}", leaf("norm1", n)) for n in first["norm1"]]
    if kind in (MAMBA2, RGLRU):
        mixer = "mixer" if kind == MAMBA2 else "rec"
        out += [(f"{pre}/{mixer}/{n}", leaf(mixer, n)) for n in MIXER_LEAVES[mixer]]
        if kind == MAMBA2:
            return out + [(f"{pre}/mixer/gate_norm/{n}", leaf("mixer", "gate_norm", n))
                          for n in first["mixer"]["gate_norm"]]
    else:
        out += _attn_leaves(f"{pre}/attn", lambda n: leaf("attn", n), lead, cfg)
    out += [(f"{pre}/norm2/{n}", leaf("norm2", n)) for n in first["norm2"]]
    if "moe" in first:
        out += [(f"{pre}/moe/router", leaf("moe", "router"))]
        out += _mlp_leaves(f"{pre}/moe", lambda n: leaf("moe", n), cfg.moe_d_ff, "swiglu")
        if "dense" in first["moe"]:
            out += _mlp_leaves(f"{pre}/moe/dense", lambda n: leaf("moe", "dense", n),
                               cfg.d_ff, "swiglu")
    else:
        out += _mlp_leaves(f"{pre}/mlp", lambda n: leaf("mlp", n), cfg.d_ff, cfg.mlp_type)
    return out


def _encdec_leaves(params, cfg: ModelConfig):
    """(path, tensor) of the encoder-decoder's layers under ``enc_scan`` and
    ``dec_scan``, each leaf stacked over the layers, and ``enc_norm``."""
    out = [(f"enc_norm/{n}", t) for n, t in params["enc_norm"].items()]
    for group, key in (("enc_scan", "enc_layers"), ("dec_scan", "dec_layers")):
        layers = params[key]
        leaf = _stacked(layers)
        for name, sub in layers[0].items():
            if name == "mlp":
                out += _mlp_leaves(f"{group}/mlp", lambda n: leaf("mlp", n), cfg.d_ff,
                                   cfg.mlp_type)
            elif name.startswith("norm"):
                out += [(f"{group}/{name}/{n}", leaf(name, n)) for n in sub]
            else:
                out += _attn_leaves(f"{group}/{name}", lambda n, a=name: leaf(a, n),
                                    (len(layers),), cfg)
    return out


def _jax_leaves(params, cfg: ModelConfig):
    """(path, tensor) of the decoder LM or the encoder-decoder in the
    reference's layout."""
    out = [("embed", params["embed"])]
    out += [(f"final_norm/{n}", t) for n, t in params["final_norm"].items()]
    if "enc_layers" in params:
        return out + _encdec_leaves(params, cfg)
    if "lm_head" in params:
        out.append(("lm_head", params["lm_head"]))
    if "frontend_proj" in params:
        out.append(("frontend_proj", params["frontend_proj"]))
    slots = layer_slots(cfg)
    for j, kind in enumerate(cfg.block_pattern):
        layers = [p for p, s in zip(params["layers"], slots) if s[1:3] == ("scan", j)]
        out += _group_leaves(f"scan/{j}", kind, layers, True, cfg)
    for i, kind in enumerate(cfg.pattern_remainder):
        layers = [p for p, s in zip(params["layers"], slots) if s[1:3] == ("rem", i)]
        out += _group_leaves(f"rem/{i}", kind, layers, False, cfg)
    return out


def torch_params_to_jax(params, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The port's decoder-LM or encoder-decoder parameters as the
    reference's flattened tree ``{path: array}`` (layers stacked under
    ``scan/<j>/``, remainder layers under ``rem/<i>/``, or under
    ``enc_scan/`` and ``dec_scan/``; ``w_qkv`` split
    into ``w_q``/``w_k``/``w_v`` (d,h,dh), ``w_o`` (h,dh,d), ``b_qkv`` into
    ``b_q``/``b_k``/``b_v`` (h,dh), ``w_gate_up`` split), on the host.  A
    bf16 leaf comes back as its exact fp32 copy; ``torch_param_dtypes``
    names the original dtypes."""
    return {k: t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16
            else t.detach().cpu().numpy() for k, t in _jax_leaves(params, cfg)}


def torch_param_dtypes(params, cfg: ModelConfig) -> Dict[str, str]:
    """{path: original dtype name} of ``torch_params_to_jax``'s leaves."""
    return {k: str(t.dtype).removeprefix("torch.") for k, t in _jax_leaves(params, cfg)}


def jax_leaf_shapes(params, cfg: ModelConfig) -> Dict[str, tuple]:
    """{path: (shape, torch dtype)} of ``torch_params_to_jax``'s leaves,
    without reading a value: the same walk over meta copies of the leaves
    (stacking and splitting meta tensors allocates nothing), so it takes a
    tree on the meta device, the CPU or the card alike."""
    def meta(t):
        if isinstance(t, dict):
            return {k: meta(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(meta(v) for v in t)
        return t.detach().to("meta")
    return {k: (tuple(t.shape), t.dtype) for k, t in _jax_leaves(meta(params), cfg)}
