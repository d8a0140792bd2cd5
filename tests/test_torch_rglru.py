"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's ``repro.models.rglru`` on the CPU, fp32, at recurrentgemma-9b's
SMOKE widths (d 128, RNN width 128, conv width 4).

Same weights (the reference's init, its zero biases redrawn from numpy so
that they count), same numpy inputs: ``rglru_forward``'s output and both
states, a chain of ``rglru_decode`` steps continuing it, and gradients of a
loss in every weight and the input against ``jax.grad``.

The port's scan is a log-depth doubling over the sequence; the reference's
``jax.lax.associative_scan`` combines in another tree order, which cannot be
reproduced, so the two agree to rounding: activations and states within
rtol/atol 1e-5, gradients within 1e-4 of each array's largest |g|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JaxModelConfig
from repro.models import rglru as jrglru
from repro_torch import configs
from repro_torch.models import rglru
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg():
    return configs.get_config("recurrentgemma-9b", smoke=True)


def _jax_cfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed=0):
    jp = jrglru.init_rglru(jax.random.PRNGKey(seed), _jax_cfg(cfg))
    rng = np.random.default_rng(seed + 100)
    for name in ("conv_b", "b_a", "b_i"):
        jp[name] = jnp.asarray(0.3 * rng.standard_normal(jp[name].shape), jp[name].dtype)
    return jp, {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}


@pytest.mark.parametrize("s", [1, 2, 13, 64])
def test_linear_scan_is_the_recurrence(s):
    """The doubling scan against the sequential recurrence h_t = a_t h_{t-1}
    + b_t, at lengths that are and are not powers of two."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 8)))
    b = torch.from_numpy(rng.standard_normal((2, s, 8)))
    h, want = torch.zeros(2, 8, dtype=torch.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b), torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def test_rglru_forward_and_decode_match_jax():
    """A 29-token prompt: output, the fp32 state ``h`` (the scan's last
    row) and the conv state (the last 3 inputs of the conv, no silu); then
    5 decode steps continuing it."""
    cfg = _cfg()
    jp, pp = _params(cfg)
    jcfg = _jax_cfg(cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 29, cfg.d_model)).astype(np.float32)
    yj, sj = jax.jit(jrglru.rglru_forward, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    decode = jax.jit(jrglru.rglru_decode, static_argnums=3)
    yt, st = rglru.rglru_forward(pp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    assert set(st) == set(sj) == {"h", "conv"} and st["h"].dtype == torch.float32
    for leaf in st:
        np.testing.assert_allclose(st[leaf].numpy(), np.asarray(sj[leaf]), **TOL)
    for _ in range(5):
        xt = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        yj, sj = decode(jp, jnp.asarray(xt), sj, jcfg)
        yt, st = rglru.rglru_decode(pp, torch.from_numpy(xt), st, cfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        for leaf in st:
            np.testing.assert_allclose(st[leaf].numpy(), np.asarray(sj[leaf]), **TOL)


def test_rglru_gradients_match_jax():
    cfg = _cfg()
    jp, pp = _params(cfg, seed=1)
    jcfg = _jax_cfg(cfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    wy = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    wh = rng.standard_normal((2, cfg.resolved_rnn_width)).astype(np.float32)

    def jloss(p, xx):
        y, st = jrglru.rglru_forward(p, xx, jcfg)
        return jnp.sum(y * wy) + jnp.sum(st["h"] * wh)

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in pp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, st = rglru.rglru_forward(leaves, xt, cfg)
    (torch.sum(y * torch.from_numpy(wy)) + torch.sum(st["h"] * torch.from_numpy(wh))).backward()
    pairs = [(name, leaves[name].grad, gp[name]) for name in leaves] + [("x", xt.grad, gx)]
    for name, got, ref in pairs:
        scale = float(np.abs(np.asarray(ref)).max())
        assert scale > 0 and np.isfinite(got.numpy()).all(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_gates_stay_fp32_and_init_matches_the_reference_layout():
    cfg = _cfg().replace(dtype="bfloat16")
    p = rglru.init_rglru(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jrglru.init_rglru(jax.random.PRNGKey(0), _jax_cfg(cfg))
    assert set(p) == set(jp)
    for name, leaf in p.items():
        assert tuple(leaf.shape) == jp[name].shape, name
        assert str(leaf.dtype).removeprefix("torch.") == str(jp[name].dtype), name
    a = torch.sigmoid(p["lam"])
    assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y, st = rglru.rglru_forward(p, x.to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16 and st["h"].dtype == torch.float32
    assert st["conv"].dtype == torch.bfloat16
    zero = rglru.init_rglru_state(2, cfg, "cpu", lead=(3,))
    assert zero["h"].shape == (3, 2, cfg.resolved_rnn_width)
    assert zero["conv"].shape == (3, 2, cfg.rglru_conv_width - 1, cfg.resolved_rnn_width)
