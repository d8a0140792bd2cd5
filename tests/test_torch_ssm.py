"""The port's Mamba-2 SSD mixer (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU, fp32, at mamba2-130m's SMOKE
widths (d 128, 8 heads of 32, state 16, chunk 16).

Same weights (the reference's init, its zero biases and unit skips redrawn
from numpy so that they count), same numpy inputs: the chunked SSD at
``S % chunk != 0`` (front padding), at ``S < chunk`` and from an initial
state; ``mamba2_forward``'s output and both states; a chain of
``mamba2_decode`` steps continuing a prefill; gradients of a loss through
the SSD against ``jax.grad``, finite where the causal mask applies.

Tolerances: activations and states rtol/atol 1e-5 (the two frameworks'
CPU contractions and transcendentals round differently, never by more);
gradients within 1e-4 of each array's largest |g|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JaxModelConfig
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.models import ssm
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**changes):
    return configs.get_config("mamba2-130m", smoke=True).replace(**changes)


def _jax_cfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed=0):
    """(JAX params, port params): the reference's init with its zero conv
    bias, dt bias and unit skips redrawn."""
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), _jax_cfg(cfg))
    rng = np.random.default_rng(seed + 100)
    for name, scale, shift in (("conv_b", 0.1, 0.0), ("dt_bias", 0.5, -1.0),
                               ("d_skip", 0.2, 1.0)):
        jp[name] = jnp.asarray(shift + scale * rng.standard_normal(jp[name].shape),
                               jp[name].dtype)
    jp["gate_norm"]["scale"] = jnp.asarray(1 + 0.1 * rng.standard_normal(cfg.ssm_d_inner),
                                           jnp.float32)
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    return jp, pp


def _ssd_inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    h, p, g, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0))
    return {"x": rng.standard_normal((b, s, h, p)), "b": rng.standard_normal((b, s, g, n)),
            "c": rng.standard_normal((b, s, g, n)), "dt": dt,
            "a_log": -dt * np.linspace(1.0, 16.0, h) / 4}


def _both(arrays):
    f = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    return ({k: jnp.asarray(v) for k, v in f.items()},
            {k: torch.from_numpy(v) for k, v in f.items()})


@pytest.mark.parametrize("s,h0", [(37, False), (9, False), (48, True)],
                         ids=["front-padded", "shorter-than-a-chunk", "initial-state"])
def test_ssd_chunked_matches_jax(s, h0):
    """37 tokens: three chunks of 16 after 11 zeros at the front; 9 tokens:
    one chunk of 9 (``L = min(chunk, S)``); 48 tokens from a nonzero state."""
    cfg = _cfg()
    j, t = _both(_ssd_inputs(cfg, 2, s, seed=s))
    hj = ht = None
    if h0:
        init = np.random.default_rng(7).standard_normal(
            (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32)
        hj, ht = jnp.asarray(init), torch.from_numpy(init)
    ssd = jax.jit(jssm._ssd_chunked, static_argnums=5)
    yj, lj = ssd(j["x"], j["a_log"], j["b"], j["c"], j["dt"], _jax_cfg(cfg), hj)
    yt, lt = ssm.ssd_chunked(t["x"], t["a_log"], t["b"], t["c"], t["dt"], cfg, h0=ht)
    assert yt.shape == (2, s, cfg.ssm_heads, cfg.ssm_head_dim) and lt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_front_padding_refuses_an_initial_state():
    cfg = _cfg()
    _, t = _both(_ssd_inputs(cfg, 1, 20, seed=1))
    with pytest.raises(ValueError, match="zero initial state"):
        ssm.ssd_chunked(t["x"], t["a_log"], t["b"], t["c"], t["dt"], cfg,
                        h0=torch.zeros(1, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))


@pytest.mark.parametrize("s", [37, 32])
def test_ssd_gradients_match_jax_and_stay_finite(s):
    """A weighted sum of the SSD's output and its final state, differentiated
    in all five inputs: the masked (future) entries of each chunk's decay
    matrix must not poison the gradient with 0 * inf."""
    cfg = _cfg()
    arrays = _ssd_inputs(cfg, 2, s, seed=s + 3)
    rng = np.random.default_rng(s + 4)
    wy = rng.standard_normal((2, s, cfg.ssm_heads, cfg.ssm_head_dim)).astype(np.float32)
    wh = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state)).astype(np.float32)
    names = ("x", "a_log", "b", "c", "dt")
    j, t = _both(arrays)

    def jloss(*args):
        y, h = jssm._ssd_chunked(*args, _jax_cfg(cfg))
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*(j[n] for n in names))
    leaves = [t[n].clone().requires_grad_() for n in names]
    y, h = ssm.ssd_chunked(*leaves, cfg)
    (torch.sum(y * torch.from_numpy(wy)) + torch.sum(h * torch.from_numpy(wh))).backward()
    for name, leaf, ref in zip(names, leaves, want):
        got = leaf.grad.numpy()
        assert np.isfinite(got).all(), name
        scale = float(np.abs(np.asarray(ref)).max())
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_mamba2_forward_and_decode_match_jax():
    """A 21-token prompt (front-padded to two chunks): the output, the SSM
    state and the conv state (the last 3 pre-conv inputs); then 6 decode
    steps continuing it, each step's output and both states."""
    cfg = _cfg()
    jp, pp = _params(cfg)
    jcfg = _jax_cfg(cfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 21, cfg.d_model)).astype(np.float32)
    yj, sj = jax.jit(jssm.mamba2_forward, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    decode = jax.jit(jssm.mamba2_decode, static_argnums=3)
    yt, st = ssm.mamba2_forward(pp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    assert set(st) == set(sj) == {"ssm", "conv"}
    for leaf in st:
        np.testing.assert_allclose(st[leaf].numpy(), np.asarray(sj[leaf]), **TOL)
    assert st["conv"].shape == (3, cfg.ssm_conv_width - 1, ssm.conv_dim(cfg))
    for _ in range(6):
        xt = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        yj, sj = decode(jp, jnp.asarray(xt), sj, jcfg)
        yt, st = ssm.mamba2_decode(pp, torch.from_numpy(xt), st, cfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        for leaf in st:
            np.testing.assert_allclose(st[leaf].numpy(), np.asarray(sj[leaf]), **TOL)


def test_decode_continues_the_forward():
    """Within the port: a prompt's forward then decode steps equal the
    forward of the whole sequence at every decoded position (the state
    carries the recurrence exactly, up to the order of the sums)."""
    cfg = _cfg()
    _, pp = _params(cfg, seed=2)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    full, _ = ssm.mamba2_forward(pp, x, cfg)
    _, state = ssm.mamba2_forward(pp, x[:, :18], cfg)
    for i in range(18, 24):
        y, state = ssm.mamba2_decode(pp, x[:, i:i + 1], state, cfg)
        torch.testing.assert_close(y[:, 0], full[:, i], rtol=1e-5, atol=1e-5)


def test_zero_state_and_init_shapes():
    cfg = _cfg()
    st = ssm.init_mamba2_state(2, cfg, "cpu", lead=(3,))
    assert st["ssm"].shape == (3, 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    assert st["ssm"].dtype == torch.float32 and not st["ssm"].any()
    full = configs.get_config("mamba2-130m")
    st = ssm.init_mamba2_state(1, full, "meta")
    assert st["conv"].dtype == torch.bfloat16 and st["conv"].shape == (1, 3, 1536 + 256)
    p = ssm.init_mamba2(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jssm.init_mamba2(jax.random.PRNGKey(0), _jax_cfg(cfg))
    for name, leaf in p.items():
        ref = jp[name]
        if isinstance(leaf, dict):
            leaf, ref = leaf["scale"], ref["scale"]
        assert tuple(leaf.shape) == ref.shape and str(leaf.dtype)[6:] == str(ref.dtype), name
    np.testing.assert_allclose(p["a_log"].numpy(), np.asarray(jp["a_log"]), rtol=1e-6)
