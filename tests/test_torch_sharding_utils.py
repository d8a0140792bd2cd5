"""``models/sharding_utils.constrain`` against the reference's on the CPU.

The port's ``constrain`` returns its input unchanged (one process drives
one card); under ``launch.mesh.use_mesh(mesh, log)`` it logs the spec the
reference would apply.  The reference's spec is captured by replacing
``jax.lax.with_sharding_constraint`` inside the test (nothing in
``src/repro`` changes) under a ``jax.sharding.AbstractMesh`` of the same
shape.  Held: ``resolve`` on a table of shapes and specs on the 16 x 16
and 2 x 16 x 16 meshes and off-mesh; the whole sequence of (shape, spec)
that a forward, a prefill and a decode step place, at the reference's call
sites, for a dense, a MoE and an encoder-decoder smoke config (the
reference traces a scanned layer's body once where the port runs each
layer, so the entries of consecutive layers count once); and the outputs
bit for bit with and without the mesh.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint.checkpoint import _flatten
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.models import sharding_utils as jax_shu
from repro_torch import configs
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.launch.mesh import make_production_mesh, use_mesh
from repro_torch.models import build_model
from repro_torch.models import sharding_utils as shu
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

MESHES = {"16x16": False, "2x16x16": True}
B = shu.BATCH
TABLE = [((32, 4, 8), (B, None, None)), ((16, 4, 512), (B, None, "model")),
         ((8, 4, 512), (B, None, "model")), ((64, 3), (B,)), ((48, 2, 30), (B, None, "model")),
         ((32, 32, 32), ("data", "model", None)), ((32, 32), (("pod", "data"), "model")),
         ((32, 16), ("pod", None)), ((5,), ()), ((16, 2), (None, "model"))]


@contextlib.contextmanager
def _reference_log(multi_pod):
    """The reference's (shape, spec) of each constrain under an abstract
    mesh, or off-mesh with ``multi_pod`` None."""
    log = []
    inner = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = lambda x, s: (log.append((tuple(x.shape), tuple(s))),
                                                      x)[1]
    try:
        if multi_pod is None:
            yield log
        else:
            shape = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
                ((16, 16), ("data", "model"))
            with jax.sharding.use_abstract_mesh(AbstractMesh(*shape)):
                yield log
    finally:
        jax.lax.with_sharding_constraint = inner


@pytest.mark.parametrize("mesh_name", list(MESHES) + [None])
def test_resolve_matches_the_reference(mesh_name):
    multi = MESHES.get(mesh_name)
    with _reference_log(multi) as log:
        for shape, spec in TABLE:
            jax_shu.constrain(jnp.zeros(shape), *spec)
    mesh = None if mesh_name is None else make_production_mesh(multi_pod=multi)
    got = [shu.resolve(shape, *spec, mesh=mesh) for shape, spec in TABLE]
    if mesh_name is None:
        assert log == [] and got == [None] * len(TABLE)
    else:
        assert got == [s for _, s in log]
        assert [shape for shape, _ in TABLE] == [shape for shape, _ in log]


def _jax_cfg(cfg):
    return JaxModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.enc_layers:
        batch["frames"] = rng.standard_normal((b, cfg.enc_frames, cfg.d_model)).astype(
            np.float32)
    return batch, rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)


def _runs(log):
    return [e for i, e in enumerate(log) if i == 0 or log[i - 1] != e]


def _port_run(pm, pp, batch, token, cap):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _ = pm.forward(pp, t)
    last, caches = pm.prefill(pp, t, cap)
    step, _ = pm.decode_step(pp, torch.from_numpy(token), caches)
    return logits, last, step


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["llama-3.1-8b", "qwen3-moe-235b-a22b", "whisper-tiny"])
def test_call_sites_place_what_the_reference_places(arch, mesh_name):
    cfg = configs.get_config(arch, smoke=True)
    if cfg.num_experts:
        cfg = cfg.replace(moe_group_size=8)      # 16 groups of the 128 tokens
    jm = jax_build_model(_jax_cfg(cfg))
    jp = jm.init(jax.random.PRNGKey(0))
    pm, pp = build_model(cfg), jax_params_to_torch(_flatten(jp), cfg, device="cpu")
    batch, token = _inputs(cfg, 32, 4)
    cap = 8

    def reference(params):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, _ = jm.forward(params, jb)
        last, caches = jm.prefill(params, jb, cap)
        return logits, last, jm.decode_step(params, jnp.asarray(token), caches)[0]

    with _reference_log(MESHES[mesh_name]) as want:
        jax.eval_shape(reference, jp)
    got = []
    with torch.no_grad():
        plain = _port_run(pm, pp, batch, token, cap)
        with use_mesh(make_production_mesh(multi_pod=MESHES[mesh_name]), got):
            placed = _port_run(pm, pp, batch, token, cap)
    # the reference traces a scanned period's body once, the port runs each
    # layer: the entries of consecutive layers collapse to one
    assert _runs(got) == _runs(want) and len(_runs(got)) >= 4
    assert any(spec[0] is not None for _, spec in got)   # BATCH resolved somewhere
    for a, b in zip(plain, placed):
        assert torch.equal(a, b)


def test_constrain_is_the_identity_off_and_on_a_mesh():
    x = torch.randn(32, 3, 16)
    assert shu.constrain(x, B, None, "model") is x
    log = []
    with use_mesh(make_production_mesh(), log):
        assert shu.constrain(x, B, None, "model") is x
        with use_mesh(make_production_mesh(multi_pod=True)):     # no log: nothing kept
            assert shu.constrain(x, B) is x
            assert shu.resolve((32, 3), B) == (("pod", "data"), None)
    assert log == [((32, 3, 16), ("data", None, "model"))]
    assert shu.resolve((32, 3), B) is None
