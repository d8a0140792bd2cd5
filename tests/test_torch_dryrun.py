"""The port's dry-run (``launch.dryrun``) against the JAX package on the CPU.

The parts of ``run_one`` that need no step (the skip status, the exact
parameter count, one device's argument bytes under the placement rules)
cover every arch x shape x mesh at full size.  The meta step (FLOPs, the
peak of live bytes, the one-card plan) runs for the six (arch, shape) pairs
the card runs, at smoke sizes; the full-size sweep is
``python -m repro_torch.launch.dryrun --all --device meta``.  A decode step
at position 524,287 is held to JAX's on the same cache for the smoke
danube ring and the smoke recurrentgemma stack.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.configs import get_config as jax_get_config
from repro.configs import skip_reason as jax_skip_reason
from repro.launch import shapes as jax_shapes
from repro.launch import sharding as jax_shd
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.training import init_opt_state as jax_init_opt_state
from repro_torch import configs
from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.kernels import meta as kernel_meta
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from test_torch_shapes import ARCHS, MESHES, _bytes, _flat, _jax_mesh, _jax_params
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

TOL = dict(rtol=1e-5, atol=1e-5)        # test_torch_archs' and test_torch_hybrid's
REFERENCE_KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute"}    # the reference's _COLL_RE
CARD_PAIRS = [("llama-3.1-8b", "prefill_32k"), ("llama-3.1-8b", "decode_32k"),
              ("qwen2.5-3b", "train_4k"), ("h2o-danube-1.8b", "long_500k"),
              ("recurrentgemma-9b", "long_500k"), ("mamba2-130m", "long_500k")]


def _reference_bytes(arch, shape, mesh_name):
    """The reference's per-device argument bytes, part by part, as its
    dry-run places them (``repro.launch.dryrun.run_one``)."""
    cfg = jax_get_config(arch)
    jm, seq_batch_kind = _jax_mesh(mesh_name), shapes.INPUT_SHAPES[shape]
    seq, batch, kind = seq_batch_kind
    ms = dict(jm.shape)
    params = _jax_params(arch)
    p_specs = _flat(jax_shd.param_specs(jm, params, mode="serve" if kind == "decode"
                                        else "train"))
    out = {"params": _bytes(ms, _flat(params), p_specs)}
    if kind == "train":
        opt = jax.eval_shape(jax_init_opt_state, params)
        o_specs = _flat(jax_shd.opt_state_specs(jm, opt, jax_shd.param_specs(jm, params)))
        out["opt_state"] = _bytes(ms, _flat(opt), o_specs)
    if kind in ("train", "prefill"):
        inputs = (jax_shapes.train_inputs if kind == "train" else jax_shapes.prefill_inputs)(
            cfg, seq, batch)
        out["batch"] = _bytes(ms, inputs, jax_shd.batch_spec(jm, cfg))
    else:
        inputs = jax_shapes.decode_inputs(cfg, seq, batch)
        out["caches"] = _bytes(ms, _flat(inputs["caches"]),
                               _flat(jax_shd.cache_specs(jm, inputs["caches"], batch)))
        out["token"] = _bytes(ms, {"t": inputs["token"]}, {"t": jax_shd.token_spec(jm, batch)})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_run_one_without_the_step_covers_every_shape_and_mesh(arch):
    """Skip status and reason, exact and active parameter counts, and each
    part of one device's argument bytes equal the reference's, for every
    assigned shape on both production meshes; every ok record carries the
    reference's three collective keys, byte counts by the reference's kinds
    (``test_torch_collectives.py`` holds their values to the reference's)."""
    jcfg = jax_get_config(arch)
    for shape in shapes.INPUT_SHAPES:
        for mesh_name in MESHES:
            mesh = make_production_mesh(multi_pod=mesh_name != "16x16")
            rec = dryrun.run_one(arch, shape, mesh, device="meta", reckon_step=False)
            assert rec["mesh"] == mesh_name and rec["arch"] == arch
            assert rec["params_exact"] == jcfg.param_count()
            assert rec["params_active"] == jcfg.param_count(active_only=True)
            reason = jax_skip_reason(arch, shape)
            if reason:
                assert rec["status"] == "skipped" and rec["reason"] == reason
                continue
            assert rec["status"] == "ok"
            for key in ("collectives", "collectives_body_once"):
                assert set(rec[key]) <= REFERENCE_KINDS
                assert all(isinstance(v, int) and v >= 0 for v in rec[key].values())
            assert isinstance(rec["loop_trip_count"], int) and rec["loop_trip_count"] >= 1
            want = _reference_bytes(arch, shape, mesh_name)
            got = dict(rec["memory"])
            assert got.pop("argument_size_in_bytes") == sum(want.values())
            assert got == want, (shape, mesh_name)


@pytest.mark.parametrize("arch,shape", CARD_PAIRS)
def test_meta_step_and_one_card_plan_of_the_card_pairs(arch, shape):
    """The card's six pairs at smoke sizes: FLOPs and a live-byte peak that
    holds at least the step's own arguments, and a plan at the per-card
    batch (global / 16, microbatches clipped as the reference clips them)
    that fits its own reckoning."""
    rec = dryrun.run_one(arch, shape, device="meta", smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    seq, batch, kind = shapes.INPUT_SHAPES[shape]
    plan = rec["one_card"]
    assert rec["status"] == "ok" and "card" not in rec
    assert plan["batch"] == max(batch // 16, 1)
    want_mb = dryrun.clip_microbatches(cfg.train_microbatches, plan["batch"]) \
        if kind == "train" else 1
    assert plan["microbatches"] == rec["microbatches"] == want_mb
    assert plan["fits"] and plan["peak_bytes"] <= plan["budget_bytes"]
    assert plan["layers"] == plan["full_layers"] == cfg.num_layers
    args = dryrun.step_args(cfg, kind, seq, plan["batch"], shapes.META)
    arg_bytes = sum(t.untyped_storage().nbytes() for t in _tensors(args))
    assert rec["flops"] > 0 and rec["peak_bytes"] >= arg_bytes
    assert (plan["flops"], plan["peak_bytes"]) == (rec["flops"], rec["peak_bytes"])


def _tensors(tree):
    from repro_torch.training.optimizer import tree_leaves
    return [t for t in tree_leaves(list(tree)) if isinstance(t, torch.Tensor)]


def test_prefill_flops_of_the_llama_smoke_config_are_written_out():
    """2 * (matmul weights) * tokens, the last token's head, and 4 * dh per
    allowed (query, key, head) of the causal attention in every layer."""
    cfg = configs.get_config("llama-3.1-8b", smoke=True)
    rec = dryrun.run_one("llama-3.1-8b", "prefill_32k", device="meta", smoke=True)
    d, h, hk, dh, f, n = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                          cfg.d_ff, cfg.num_layers)
    b, s = 2, 32_768
    weights = n * (d * (h + 2 * hk) * dh + h * dh * d + 3 * d * f)
    head = d * cfg.padded_vocab * b
    attention = n * 4 * dh * h * b * s * (s + 1) // 2
    assert rec["flops"] == 2 * weights * b * s + 2 * head + attention


def test_live_bytes_counts_storages_once_and_frees_them():
    meta = torch.device("meta")
    a = torch.empty(100, device=meta)
    with dryrun.LiveBytes() as live:
        live.track(a)
        live.track(a[10:])              # a view: the same storage
        b = a * 2
        c = b.view(10, 10)
        del b
        d = c + 1                       # c keeps b's storage alive: 3 at once
        del c, d
        e = a.float()                   # already fp32: no new storage
        f = a + 1
    assert live.peak == 3 * 400 and live.live == 2 * 400 and e is a
    del f


def test_plan_cuts_depth_to_the_largest_fit(monkeypatch):
    """With the card made small, the plan keeps the most whole periods whose
    reckoned peak fits, and one more does not fit."""
    cfg = configs.get_config("llama-3.1-8b", smoke=True).replace(num_layers=8)
    kind, seq, batch = "prefill", 256, 2
    full = dryrun.reckon(cfg, kind, seq, batch)
    peaks = {n: dryrun.reckon(dryrun.cut_depth(cfg, n), kind, seq, batch)[1]
             for n in range(1, 9)}
    assert peaks[8] == full[1] and all(peaks[n] < peaks[n + 1] for n in range(1, 8))
    budget = (peaks[5] + peaks[6]) // 2
    monkeypatch.setattr(dryrun, "CARD_BYTES", budget / (1 - dryrun.HEADROOM) + 1)
    plan = dryrun.one_card_plan(cfg, kind, seq, batch, 1, full)
    assert plan["fits"] and plan["layers"] == plan["periods"] == 5
    assert plan["peak_bytes"] == peaks[5] and plan["full_layers"] == 8
    rg = configs.get_config("recurrentgemma-9b")
    assert dryrun.cut_depth(rg, 12) is rg and dryrun.cut_depth(rg, 4).num_layers == 12
    wh = configs.get_config("whisper-tiny")
    assert dryrun.cut_depth(wh, 2).num_layers == dryrun.cut_depth(wh, 2).enc_layers == 2


def _jax_pair(cfg, seed=0):
    jm = jax_build_model(JaxModelConfig(**dataclasses.asdict(cfg)))
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(cfg), jax_params_to_torch(_flatten(jp), cfg, device="cpu")


def _to_jax_caches(jm, pc, b, cap):
    """The port's dense caches in the reference's tree: every leaf copied,
    and the reference's int32 ``pos`` in each KV entry and at the top."""
    jc = jax.eval_shape(lambda: jm.init_caches(b, cap))
    pos = pc["pos"]

    def entry(j_entry, p_entry):
        # copies: JAX on the CPU may alias a numpy buffer, which the port's
        # decode then writes in place while JAX still reads it
        out = {k: jnp.asarray(t.numpy().copy()) for k, t in p_entry.items()}
        if "pos" in j_entry:
            out["pos"] = jnp.full(j_entry["pos"].shape, pos, jnp.int32)
        return out

    return {"scan": tuple(entry(j, p) for j, p in zip(jc["scan"], pc["scan"])),
            "rem": tuple(entry(j, p) for j, p in zip(jc["rem"], pc["rem"])),
            "pos": jnp.asarray(pos, jnp.int32)}


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-9b"])
def test_decode_at_position_524287_matches_jax(arch):
    """Caches filled as the card's long_500k run fills them (random K/V and
    states, each ring slot holding the last position congruent to it),
    ``pos`` 524,287: three decode steps of the smoke stack against JAX's
    ``decode_step`` on the same cache, logits and every cache leaf."""
    cfg = configs.get_config(arch, smoke=True)
    jm, jp, pm, pp = _jax_pair(cfg)
    b, pos = 2, 524_287
    cap = shapes.decode_capacity(pos)
    pc = pm.init_caches(b, cap, "cpu")
    dryrun.fill_decode_caches(pc, pos, torch.Generator().manual_seed(3))
    ring = next(e for e in pc["scan"] if "slot_pos" in e)["slot_pos"]
    w = cfg.sliding_window
    assert ring.shape[-1] == w
    assert sorted(ring[0, 0].tolist()) == list(range(pos - w, pos))
    assert all(p % w == s for s, p in enumerate(ring[0, 0].tolist()))
    jc = _to_jax_caches(jm, pc, b, cap)
    step = jax.jit(jm.decode_step)
    rng = np.random.default_rng(4)
    for _ in range(3):
        tok = rng.integers(5, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = step(jp, jnp.asarray(tok), jc)
        pl, pc = pm.decode_step(pp, torch.from_numpy(tok), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        for got, want in zip(pc["scan"] + pc["rem"], jc["scan"] + jc["rem"]):
            for leaf, t in got.items():
                np.testing.assert_allclose(t.numpy(), np.asarray(want[leaf]), **TOL,
                                           err_msg=leaf)
    assert pc["pos"] == int(jc["pos"]) == pos + 3


@pytest.mark.parametrize("arch,kind", [("h2o-danube-1.8b", "decode"),
                                       ("recurrentgemma-9b", "decode"),
                                       ("llama-3.1-8b", "decode"), ("whisper-tiny", "decode"),
                                       ("llama-3.1-8b", "prefill"), ("qwen2.5-3b", "train")])
def test_card_run_of_a_smoke_plan_on_the_cpu(arch, kind):
    """The plan's run at a smoke size on the CPU: finite outputs, and a
    decode's two runs from one cache (its overwritten slots and states put
    back between them) bitwise equal; without putting them back a ring's
    second run differs."""
    cfg = configs.get_config(arch, smoke=True)
    seq = 40 if kind == "decode" else 32
    rec = dryrun.card_run(cfg, kind, seq, 2, 2 if kind == "train" else 1, "cpu", seed=1)
    assert rec["ok"] and rec["layers"] == cfg.num_layers and rec["launches"] == {}
    assert rec["max_memory_allocated"] is None and rec["device_name"] == "cpu"
    if kind == "decode":
        assert rec["bitwise_repeat"] and rec["pos"] == seq
        assert len(rec["ms_steps"]) == dryrun.DECODE_STEPS
    if kind == "train":
        assert all(np.isfinite(rec["losses"])) and rec["microbatches"] == 2
    if arch == "h2o-danube-1.8b":       # a ring past its window: the restore matters
        pm = build_model(cfg)
        gen = torch.Generator().manual_seed(1)
        params = pm.init(gen, "cpu")
        caches = pm.init_caches(2, shapes.decode_capacity(seq), "cpu")
        dryrun.fill_decode_caches(caches, seq, gen)
        tok = torch.tensor([7, 9], dtype=torch.int32)
        saved = dryrun.snapshot(caches, cfg, dryrun.DECODE_STEPS)
        first, _ = dryrun.decode_run(pm, params, tok, caches, dryrun.DECODE_STEPS)
        caches["pos"] = seq
        stale, _ = dryrun.decode_run(pm, params, tok, caches, dryrun.DECODE_STEPS)
        dryrun.restore(caches, saved)
        again, _ = dryrun.decode_run(pm, params, tok, caches, dryrun.DECODE_STEPS)
        assert torch.equal(first, again) and not torch.equal(first, stale)


def test_cli_writes_records_for_a_run_and_a_skip(tmp_path, capsys):
    """``--device meta`` reckons without a card; a skipped pair records the
    reference's reason; nothing fails."""
    rc = dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--mesh", "single",
                      "--device", "meta", "--out-dir", str(tmp_path)])
    rc2 = dryrun.main(["--arch", "llama-3.1-8b", "--shape", "long_500k", "--mesh", "multi",
                       "--device", "meta", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == rc2 == 0 and "[ok] mamba2-130m long_500k 16x16" in out
    rec = json.loads((tmp_path / "mamba2-130m__long_500k__16x16.json").read_text())
    assert rec["status"] == "ok" and rec["one_card"]["layers"] == 24
    assert rec["flops"] > 0 and kernel_meta.flops == 0     # an attention-free stack
    skip = json.loads((tmp_path / "llama-3.1-8b__long_500k__2x16x16.json").read_text())
    assert skip["status"] == "skipped" and skip["reason"] == jax_skip_reason("llama-3.1-8b",
                                                                              "long_500k")
