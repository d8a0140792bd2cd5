"""The assigned input shapes and the placement rules of the port against the
JAX package's, at full size, on both production meshes.

The reference's trees come from ``jax.eval_shape`` (no allocation) and its
specs from ``launch/sharding.py`` over ``jax.sharding.AbstractMesh``, which
needs no devices; the port's from meta tensors.  Leaves are matched by the
reference's path names (``checkpoint.convert``'s walk for the parameters).
The dense caches' ``pos`` is a host int in the port and int32 arrays in the
reference (one per KV entry and one at the top): ``sharding.cache_leaves``
adds the reference's, and the port's own ``pos`` is checked to be an int.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.launch import mesh as jax_mesh
from repro.launch import shapes as jax_shapes
from repro.launch import sharding as jax_shd
from repro.training import init_opt_state as jax_init_opt_state
from repro_torch import configs
from repro_torch.launch import mesh, shapes
from repro_torch.launch import sharding as shd
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

ARCHS = list(configs.ASSIGNED_ARCHS) + ["llama-3.1-8b"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _flat(tree):
    """{reference path: leaf} of a JAX tree (specs kept whole)."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {_path(p): x for p, x in leaves}


def _leaf(x):
    return tuple(x.shape), np.dtype(x.dtype).name


def _port_leaf(leaf):
    return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax_shapes.abstract_params(jax_get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_param_leaves(arch):
    cfg = configs.get_config(arch)
    return shd.param_leaves(shapes.abstract_params(cfg), cfg)


def _jax_mesh(name):
    return AbstractMesh(*MESHES[name])


def _bytes(mesh_shape, leaves: dict, specs: dict) -> int:
    """The reference's specs applied to its leaves: one device's bytes."""
    total = 0
    for k, x in leaves.items():
        spec = tuple(specs[k]) + (None,) * (len(x.shape) - len(specs[k]))
        n = 1
        for dim, axis in zip(x.shape, spec):
            names = () if axis is None else axis if isinstance(axis, tuple) else (axis,)
            n *= -(-dim // int(np.prod([mesh_shape[a] for a in names])))
        total += n * np.dtype(x.dtype).itemsize
    return total


def _same_specs(port: dict, ref: dict):
    assert set(port) == set(ref)
    bad = {k: (port[k], tuple(ref[k])) for k in ref if port[k] != tuple(ref[k])}
    assert not bad, list(bad.items())[:4]


def test_input_shapes_and_capacity_are_the_reference_s():
    assert shapes.INPUT_SHAPES == jax_shapes.INPUT_SHAPES
    for seq in (1, 248, 249, 4_096, 32_768, 524_288, 524_295):
        assert shapes.decode_capacity(seq) == jax_shapes.decode_capacity(seq)
    assert configs.ASSIGNED_ARCHS == __import__("repro.configs").configs.ASSIGNED_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_inputs_match_the_reference(arch):
    """Every parameter leaf's shape and dtype under the reference's path
    names, and the train, prefill and decode inputs of every assigned shape
    (decode caches at the shape's global batch)."""
    cfg, jcfg = configs.get_config(arch), jax_get_config(arch)
    ref = {k: _leaf(x) for k, x in _flat(_jax_params(arch)).items()}
    got = {k: _port_leaf(x) for k, x in _port_param_leaves(arch).items()}
    assert got == ref
    for name, (seq, batch, kind) in shapes.INPUT_SHAPES.items():
        if kind == "train":
            pairs = [(shapes.train_inputs(cfg, seq, batch),
                      jax_shapes.train_inputs(jcfg, seq, batch)),
                     (shapes.prefill_inputs(cfg, seq, batch),
                      jax_shapes.prefill_inputs(jcfg, seq, batch))]
            for port, want in pairs:
                assert all(t.device.type == "meta" for t in port.values())
                assert {k: _port_leaf(t) for k, t in port.items()} == {
                    k: _leaf(x) for k, x in want.items()}
        elif kind == "decode":
            port = shapes.decode_inputs(cfg, seq, batch)
            want = jax_shapes.decode_inputs(jcfg, seq, batch)
            assert isinstance(port["caches"]["pos"], int)      # the port's host int
            assert _port_leaf(port["token"]) == _leaf(want["token"])
            got = {k: _port_leaf(v) for k, v in shd.cache_leaves(port["caches"]).items()}
            assert got == {k: _leaf(x) for k, x in _flat(want["caches"]).items()}, name


def test_the_train_cli_and_the_dry_run_share_the_frontend_rule():
    """``frontend_inputs`` draws what ``frontend_shapes`` names, which is
    what the reference's ``train_inputs`` holds besides the tokens."""
    for arch in ARCHS:
        cfg = configs.get_config(arch, smoke=True)
        drawn = train_cli.frontend_inputs(cfg, 2, np.random.default_rng(0), "cpu")
        named = shapes.frontend_shapes(cfg, 2)
        assert {k: tuple(t.shape) for k, t in drawn.items()} == named
        ref = jax_shapes.train_inputs(jax_get_config(arch, smoke=True), 8, 2)
        assert named == {k: tuple(x.shape) for k, x in ref.items()
                         if k not in ("tokens", "targets", "mask")}


def test_named_meshes():
    for name, (sizes, axes) in MESHES.items():
        m = mesh.make_production_mesh(multi_pod=len(sizes) == 3)
        assert m.name == name and m.axis_names == axes
        assert m.shape == dict(_jax_mesh(name).shape)
        assert mesh.batch_axes(m) == jax_mesh.batch_axes(_jax_mesh(name))
    with pytest.raises(ValueError):
        mesh.make_host_mesh()          # no CUDA device here


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placement_specs_and_bytes_match_the_reference(arch, mesh_name):
    """``param_specs`` (train, serve), ``opt_state_specs`` (plain and
    ZeRO-1), ``batch_spec``, ``cache_specs`` (decode_32k at batch 128,
    long_500k at batch 1) and ``token_spec`` equal the reference's
    ``PartitionSpec``s leaf by leaf, and ``per_device_bytes`` equals the
    reference's specs applied to its leaves."""
    cfg, jcfg = configs.get_config(arch), jax_get_config(arch)
    jm, pm = _jax_mesh(mesh_name), mesh.make_production_mesh(multi_pod=mesh_name != "16x16")
    jparams, pleaves = _jax_params(arch), _port_param_leaves(arch)
    jleaves = _flat(jparams)
    jopt = _flat(jax.eval_shape(jax_init_opt_state, jparams))
    for mode in ("train", "serve"):
        want = _flat(jax_shd.param_specs(jm, jparams, mode=mode))
        got = shd.param_specs(pm, pleaves, mode)
        _same_specs(got, want)
        assert shd.per_device_bytes(pleaves, got, pm) == _bytes(pm.shape, jleaves, want)
        want_o = _flat(jax_shd.opt_state_specs(jm, None, jax_shd.param_specs(jm, jparams,
                                                                             mode=mode)))
        got_o = shd.opt_state_specs(pm, got)
        _same_specs(got_o, want_o)
        assert (shd.per_device_bytes(shd.opt_state_leaves(pleaves), got_o, pm)
                == _bytes(pm.shape, jopt, want_o))
    _same_specs(shd.batch_spec(pm, cfg), jax_shd.batch_spec(jm, jcfg))
    for shape in ("decode_32k", "long_500k"):
        seq, batch, _ = shapes.INPUT_SHAPES[shape]
        if configs.skip_reason(arch, shape):
            continue
        port = shd.cache_leaves(shapes.decode_inputs(cfg, seq, batch)["caches"])
        ref = jax_shapes.decode_inputs(jcfg, seq, batch)["caches"]
        want = _flat(jax_shd.cache_specs(jm, ref, batch))
        got = shd.cache_specs(pm, port, batch)
        _same_specs(got, want)
        assert shd.per_device_bytes(port, got, pm) == _bytes(pm.shape, _flat(ref), want)
        assert shd.token_spec(pm, batch) == tuple(jax_shd.token_spec(jm, batch))


def test_best_spec_and_strip_axis_match_the_reference():
    jm, pm = _jax_mesh("2x16x16"), mesh.make_production_mesh(multi_pod=True)
    for shape in ((4096, 32, 128), (1024, 6, 64), (7, 3)):
        for cands in ([("data", "model", None)], [(("pod", "data"), None), ("model",)],
                      [(("data", "model"), None, None)]):
            assert shd.best_spec(pm, shape, cands) == tuple(jax_shd.best_spec(jm, shape, cands))
    for spec in ((("data", "model"), None), ("data",), (("pod", "data"), "model"), ()):
        assert shd._strip_axis(spec, "data") == tuple(jax_shd._strip_axis(P(*spec), "data"))


def test_make_step_fn_runs_each_kind_on_meta():
    """The step of each kind over meta inputs: the shapes the reference's
    step returns, with no storage touched."""
    cfg = configs.get_config("llama-3.1-8b", smoke=True)
    params = shapes.abstract_params(cfg)
    logits, caches = shapes.make_step_fn(cfg, "prefill")(params,
                                                         shapes.prefill_inputs(cfg, 40, 2))
    assert logits.shape == (2, cfg.padded_vocab) and logits.device.type == "meta"
    assert caches["scan"][0]["k"].shape[2] == shapes.decode_capacity(40)
    d = shapes.decode_inputs(cfg, 40, 2)
    logits, caches = shapes.make_step_fn(cfg, "decode")(params, d["token"], d["caches"])
    assert logits.shape == (2, cfg.padded_vocab) and caches["pos"] == 1
    loss = shapes.make_step_fn(cfg, "train", with_optimizer=False)(
        params, shapes.train_inputs(cfg, 16, 2))
    assert loss.shape == () and loss.device.type == "meta"
    assert build_model(cfg).cfg is cfg
    with pytest.raises(ValueError):
        shapes.make_step_fn(cfg, "serve")


def test_meta_kernel_branches_return_shapes_and_add_their_work_once():
    """On meta tensors the flash and decode entries return an empty meta
    output of the kernel's shape and dtype and add 4 * dh FLOPs per allowed
    (query, key, head) once a call; CPU tensors still take the plain
    version and add nothing."""
    from repro_torch.kernels import meta
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    m = torch.device("meta")
    b, s, h, hk, dh = 2, 40, 4, 2, 16
    q = torch.empty(b, s, h, dh, dtype=torch.bfloat16, device=m)
    k = torch.empty(b, s, hk, dh, dtype=torch.bfloat16, device=m)
    pos = torch.empty(b, s, dtype=torch.int32, device=m)
    for causal, window, pairs in ((True, 0, s * (s + 1) // 2), (False, 0, s * s),
                                  (True, 8, sum(min(i + 1, 8) for i in range(s)))):
        meta.flops = 0
        out = fops.flash_attention(q, k, k, pos, pos, causal=causal, window=window,
                                   block_q=16, block_k=16)
        assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == "meta"
        assert meta.flops == 4 * dh * b * h * pairs
    # a suffix of 8 queries over 40 keys: the last 8 positions
    meta.flops = 0
    fops.flash_attention(q[:, :8].contiguous(), k, k, pos[:, :8], pos, causal=True, window=0,
                         block_q=16, block_k=16)
    assert meta.flops == 4 * dh * b * h * sum(range(33, 41))
    meta.flops = 0
    qd = torch.empty(b, h, dh, dtype=torch.bfloat16, device=m)
    kc = torch.empty(b, 96, hk, dh, dtype=torch.bfloat16, device=m)
    out = dops.decode_attention(qd, kc, kc, torch.empty(b, dtype=torch.int32, device=m))
    assert out.shape == qd.shape and out.dtype == qd.dtype and out.device.type == "meta"
    assert meta.flops == 4 * dh * b * h * 96
    meta.flops = 0
    g = torch.Generator().manual_seed(0)
    qc = torch.randn(b, h, dh, generator=g)
    kcpu = torch.randn(b, 96, hk, dh, generator=g)
    got = dops.decode_attention(qc, kcpu, kcpu, torch.full((b,), 50, dtype=torch.int32))
    assert meta.flops == 0 and torch.isfinite(got).all() and dops.launches == 0
