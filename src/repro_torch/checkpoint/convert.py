"""Convert the JAX package's parameters, flattened to numpy, into the port's.

The input is ``{path: array}`` keyed as ``checkpoint.read_checkpoint`` (and
the JAX package's own ``_flatten``) key them.  Two layouts are understood:

* the decoder LM of ``repro.models.transformer``: layers stacked under
  ``scan/0/...`` (one pattern position, ATTN-only) with ``embed``,
  ``final_norm`` and ``lm_head``;
* the embedder of ``repro.models.embedder``: layers stacked under
  ``scan/...``; the reranker of ``repro.models.reranker`` is that layout
  plus an fp32 ``score_head`` (d, 1).

Attention weights come as ``w_q``/``w_k``/``w_v`` (d,h,dh) and ``w_o``
(h,dh,d) and become ``w_qkv`` (d,(H+2Hk)*dh) and ``w_o`` (H*dh,d); a
swiglu MLP's ``w_gate``/``w_up`` become ``w_gate_up`` (d,2f).  Norm
parameters stay fp32; weights take the config's dtype.

``torch_params_to_jax`` is the inverse for the decoder LM: it carries the
port's weights back to the reference's layout (``checkpoint.save_checkpoint``
writes them where the JAX package's ``load_checkpoint`` reads them).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.config import ModelConfig


def _f32(a: np.ndarray) -> np.ndarray:
    # bf16 leaves (ml_dtypes) have no torch counterpart through numpy
    return np.ascontiguousarray(a.astype(np.float32) if a.dtype.name == "bfloat16" else a)


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.tensor(_f32(a)).to(device=device, dtype=dtype)


def _norm(flat, key: str, i, device):
    out = {"scale": _tensor(flat[key + "/scale"][i] if i is not None else flat[key + "/scale"],
                            torch.float32, device)}
    if key + "/bias" in flat:
        b = flat[key + "/bias"]
        out["bias"] = _tensor(b[i] if i is not None else b, torch.float32, device)
    return out


def jax_params_to_torch(flat: Dict[str, np.ndarray], cfg: ModelConfig, device="cuda"):
    """Port parameters for ``cfg`` from a flattened JAX parameter tree, on
    ``device`` (the card unless the caller asks for ``"cpu"``)."""
    device = resolve_device(device)
    if any(k.startswith("rem/") for k in flat) or any(
            k.startswith("scan/1/") for k in flat):
        raise NotImplementedError("only single-kind (ATTN) stacks are converted")
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported")
    pre = "scan/0/" if "scan/0/attn/w_q" in flat else "scan/"
    dt = torch_dtype(cfg.dtype)
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n_layers = flat[pre + "attn/w_q"].shape[0]
    if n_layers != cfg.num_layers:
        raise ValueError(f"checkpoint has {n_layers} layers, config {cfg.num_layers}")
    layers = []
    for i in range(n_layers):
        w = lambda name, i=i: _f32(flat[pre + name][i])
        w_qkv = np.concatenate([w("attn/w_q").reshape(d, h * dh),
                                w("attn/w_k").reshape(d, hk * dh),
                                w("attn/w_v").reshape(d, hk * dh)], axis=-1)
        if cfg.mlp_type == "swiglu":
            mlp = {"w_gate_up": np.concatenate([w("mlp/w_gate"), w("mlp/w_up")], axis=-1)}
        else:
            mlp = {"w_up": w("mlp/w_up")}
        mlp["w_down"] = w("mlp/w_down")
        layers.append({
            "norm1": _norm(flat, pre + "norm1", i, device),
            "attn": {"w_qkv": _tensor(w_qkv, dt, device),
                     "w_o": _tensor(w("attn/w_o").reshape(h * dh, d), dt, device)},
            "norm2": _norm(flat, pre + "norm2", i, device),
            "mlp": {k: _tensor(v, dt, device) for k, v in mlp.items()},
        })
    params = {"embed": _tensor(flat["embed"], dt, device),
              "final_norm": _norm(flat, "final_norm", None, device),
              "layers": layers}
    if "lm_head" in flat:
        params["lm_head"] = _tensor(flat["lm_head"], dt, device)
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


def _jax_leaves(params, cfg: ModelConfig):
    """(path, tensor) of the decoder LM in the reference's layout."""
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    layers = params["layers"]
    stack = lambda get: torch.stack([get(p).detach() for p in layers])
    out = [("embed", params["embed"]), ("final_norm/scale", params["final_norm"]["scale"])]
    if "bias" in params["final_norm"]:
        out.append(("final_norm/bias", params["final_norm"]["bias"]))
    if "lm_head" in params:
        out.append(("lm_head", params["lm_head"]))
    wq, wk, wv = zip(*(p["attn"]["w_qkv"].split([h * dh, hk * dh, hk * dh], dim=-1)
                       for p in layers))
    out += [("scan/0/attn/w_q", torch.stack(wq).reshape(-1, d, h, dh)),
            ("scan/0/attn/w_k", torch.stack(wk).reshape(-1, d, hk, dh)),
            ("scan/0/attn/w_v", torch.stack(wv).reshape(-1, d, hk, dh)),
            ("scan/0/attn/w_o", stack(lambda p: p["attn"]["w_o"]).reshape(-1, h, dh, d))]
    if cfg.mlp_type == "swiglu":
        gate_up = stack(lambda p: p["mlp"]["w_gate_up"])
        out += [("scan/0/mlp/w_gate", gate_up[..., :cfg.d_ff]),
                ("scan/0/mlp/w_up", gate_up[..., cfg.d_ff:])]
    else:
        out.append(("scan/0/mlp/w_up", stack(lambda p: p["mlp"]["w_up"])))
    out.append(("scan/0/mlp/w_down", stack(lambda p: p["mlp"]["w_down"])))
    for norm in ("norm1", "norm2"):
        for leaf in layers[0][norm]:
            out.append((f"scan/0/{norm}/{leaf}", stack(lambda p: p[norm][leaf])))
    return out


def torch_params_to_jax(params, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The port's decoder-LM parameters as the reference's flattened tree
    ``{path: array}`` (layers stacked under ``scan/0/``; ``w_qkv`` split
    into ``w_q``/``w_k``/``w_v`` (d,h,dh), ``w_o`` (h,dh,d), ``w_gate_up``
    split), on the host.  A bf16 leaf comes back as its exact fp32 copy;
    ``torch_param_dtypes`` names the original dtypes."""
    return {k: t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16
            else t.detach().cpu().numpy() for k, t in _jax_leaves(params, cfg)}


def torch_param_dtypes(params, cfg: ModelConfig) -> Dict[str, str]:
    """{path: original dtype name} of ``torch_params_to_jax``'s leaves."""
    return {k: str(t.dtype).removeprefix("torch.") for k, t in _jax_leaves(params, cfg)}
