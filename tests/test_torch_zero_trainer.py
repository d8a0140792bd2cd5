"""The one-all-reduce train step (``launch/zero_trainer.py``) and the
dry-run's ``--grad-sync-once`` mode against the JAX package on the CPU.

Without a group the step is ``make_train_step(microbatches=)`` bit for
bit.  On 2 and 4 gloo ranks (one process each, spawned here) two steps of
the llama smoke config match the reference's ``make_zero_train_step``
under 4 forced host devices (a subprocess, as ``test_torch_distributed.py``
runs JAX's sharded code), from the same JAX init and the same global
batch, each rank holding its contiguous shard; every rank makes one
all-reduce a step.  Tolerances, fp32 (``test_torch_lm_training.py``'s
rule): each loss 1e-5 relative; parameters 1e-5 absolute, except that
under 0.1% of the elements (AdamW's rounding-noise elements) may differ by
up to 2 * lr a step.  The dry-run's per-device argument bytes under
``--grad-sync-once`` equal the reference's placement for that mode (params
in serve mode, the optimizer state following them) on both meshes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.launch import sharding as jax_shd
from repro.training import init_opt_state as jax_init_opt_state
from repro_torch.configs import llama31_8b
from repro_torch.launch import dryrun, shapes, zero_trainer
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.trainer import _like
from test_torch_shapes import ARCHS, MESHES, _bytes, _flat, _jax_mesh, _jax_params
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CFG = llama31_8b.SMOKE_CONFIG.replace(attention_impl="naive")
LR, STEPS, MICRO, BATCH, SEQ = 1e-3, 2, 2, 8, 16


def _batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, CFG.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
        mask = np.ones((BATCH, SEQ), np.float32)
        mask[1, :5] = 0.0
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask})
    return out


def _t(batch, rows=slice(None)):
    return {k: torch.as_tensor(v[rows]) for k, v in batch.items()}


def _env():
    return dict(os.environ, PYTHONPATH=os.path.abspath(SRC), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


# ----------------------------------------------------------- no group

def test_without_a_group_the_step_is_the_microbatched_step(monkeypatch):
    g = torch.Generator().manual_seed(5)
    model = build_model(CFG)
    a = model.init(g, torch.device("cpu"))
    b = _like(a, [t.clone() for t in tree_leaves(a)])
    oa, ob = init_opt_state(a), init_opt_state(b)
    zero = zero_trainer.make_zero_train_step(model, AdamWConfig(lr=LR), microbatches=MICRO,
                                             warmup=2, total_steps=10)
    plain = make_train_step(model, AdamWConfig(lr=LR), microbatches=MICRO, warmup=2,
                            total_steps=10)
    monkeypatch.setattr(torch.distributed, "all_reduce", None)    # no collective is made
    for batch in _batches():
        a, oa, ma = zero(a, oa, _t(batch))
        b, ob, mb = plain(b, ob, _t(batch))
        assert torch.equal(ma["loss"], mb["loss"])
    for x, y in zip(tree_leaves(a) + tree_leaves(oa["m"]) + tree_leaves(oa["v"]),
                    tree_leaves(b) + tree_leaves(ob["m"]) + tree_leaves(ob["v"])):
        assert torch.equal(x, y)


# ------------------------------------------------------- gloo vs JAX

_JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.checkpoint.checkpoint import _flatten
    from repro.launch.zero_trainer import make_zero_train_step
    from repro.models import ModelConfig, build_model
    from repro.training import AdamWConfig, init_opt_state

    fields, out = json.loads(sys.argv[1]), sys.argv[2]
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})
    data = np.load(out + ".batches.npz")
    model = build_model(cfg)
    p0 = model.init(jax.random.PRNGKey(11))
    res = {"init/" + k: v for k, v in _flatten(p0).items()}
    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
        step = jax.jit(make_zero_train_step(model, AdamWConfig(lr=float(sys.argv[3])), mesh,
                                            microbatches=int(sys.argv[4]), warmup=2,
                                            total_steps=10))
        params, opt, losses = p0, init_opt_state(p0), []
        for i in range(int(sys.argv[5])):
            batch = {k: jnp.asarray(data[f"{i}/{k}"]) for k in ("tokens", "targets", "mask")}
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        res.update({f"final{n}/" + k: v for k, v in _flatten(params).items()})
        res[f"losses{n}"] = np.asarray(losses)
    np.savez(out, **res)
    print(json.dumps({"devices": len(jax.devices())}))
""")

_RANK_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, init, base, fields = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                       sys.argv[4], json.loads(sys.argv[5]))
    lr, micro, steps = float(sys.argv[6]), int(sys.argv[7]), int(sys.argv[8])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    from repro_torch.checkpoint import jax_params_to_torch
    from repro_torch.launch import zero_trainer
    from repro_torch.models import ModelConfig, build_model
    from repro_torch.training import AdamWConfig, init_opt_state
    from repro_torch.training.optimizer import tree_leaves

    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})
    ref = np.load(base + ".npz")
    params = jax_params_to_torch({k[5:]: ref[k] for k in ref.files if k.startswith("init/")},
                                 cfg, device="cpu")
    data = np.load(base + ".batches.npz")
    calls = []
    inner = dist.all_reduce
    dist.all_reduce = lambda *a, **k: (calls.append(1), inner(*a, **k))[1]
    step = zero_trainer.make_zero_train_step(build_model(cfg), AdamWConfig(lr=lr),
                                             dist.group.WORLD, microbatches=micro,
                                             warmup=2, total_steps=10)
    opt, losses = init_opt_state(params), []
    for i in range(steps):
        b = data[f"{i}/tokens"].shape[0] // world
        rows = slice(rank * b, (rank + 1) * b)
        batch = {k: torch.as_tensor(data[f"{i}/{k}"][rows]) for k in ("tokens", "targets",
                                                                       "mask")}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    out = {"losses": losses, "all_reduces": len(calls)}
    if rank == 0:
        np.savez(base + f".port{world}.npz", *[p.numpy() for p in tree_leaves(params)])
    with open(base + f".rank{world}_{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")


def _fields():
    return json.dumps({k: list(v) if isinstance(v, tuple) else v
                       for k, v in dataclasses.asdict(CFG).items()})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's two steps on 2 and 4 devices, from one JAX init."""
    base = str(tmp_path_factory.mktemp("zero") / "ref")
    np.savez(base + ".batches.npz", **{f"{i}/{k}": v for i, b in enumerate(_batches())
                                       for k, v in b.items()})
    out = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, _fields(), base, str(LR),
                          str(MICRO), str(STEPS)], env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["devices"] == 4
    return base


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_match_the_reference_with_one_all_reduce_a_step(reference, world):
    from repro_torch.checkpoint import jax_params_to_torch
    init = f"{reference}.init{world}"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, str(r), str(world), init,
                               reference, _fields(), str(LR), str(MICRO), str(STEPS)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    ranks = []
    for r in range(world):
        with open(f"{reference}.rank{world}_{r}.json") as f:
            ranks.append(json.load(f))
    ref = np.load(reference + ".npz")
    want_losses = ref[f"losses{world}"]
    for rec in ranks:
        assert rec["all_reduces"] == STEPS                     # one collective a step
        np.testing.assert_allclose(rec["losses"], want_losses, rtol=1e-5)
        assert rec["losses"] == ranks[0]["losses"]
    final = jax_params_to_torch({k.split("/", 1)[1]: ref[k] for k in ref.files
                                 if k.startswith(f"final{world}/")}, CFG, device="cpu")
    got = np.load(f"{reference}.port{world}.npz")
    want = [t.numpy() for t in tree_leaves(final)]
    assert len(got.files) == len(want)
    diff = np.concatenate([np.abs(got[f"arr_{i}"] - w).ravel() for i, w in enumerate(want)])
    assert float((diff > 1e-5).mean()) < 1e-3
    assert float(diff.max()) <= 2 * LR * STEPS


# ------------------------------------------------- dry-run --grad-sync-once

def _reference_grad_sync_once_bytes(arch, shape, mesh_name):
    """The reference dry-run's placement under ``grad_sync_once``
    (``repro.launch.dryrun.run_one``): params in serve mode, the optimizer
    state following the params' specs, the batch over the data axes."""
    from repro.configs import get_config as jax_get_config
    from repro.launch import shapes as jax_shapes
    cfg = jax_get_config(arch)
    jm = _jax_mesh(mesh_name)
    seq, batch, _ = shapes.INPUT_SHAPES[shape]
    ms = dict(jm.shape)
    params = _jax_params(arch)
    p_specs = jax_shd.param_specs(jm, params, mode="serve")
    opt = jax.eval_shape(jax_init_opt_state, params)
    return {"params": _bytes(ms, _flat(params), _flat(p_specs)),
            "opt_state": _bytes(ms, _flat(opt), _flat(jax_shd.opt_state_specs(jm, opt, p_specs))),
            "batch": _bytes(ms, jax_shapes.train_inputs(cfg, seq, batch),
                            jax_shd.batch_spec(jm, cfg))}


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_sync_once_bytes_match_the_reference(arch):
    from repro.configs import skip_reason as jax_skip_reason
    for shape, (_, _, kind) in shapes.INPUT_SHAPES.items():
        if kind != "train" or jax_skip_reason(arch, shape):
            continue
        for mesh_name in MESHES:
            mesh = make_production_mesh(multi_pod=mesh_name != "16x16")
            rec = dryrun.run_one(arch, shape, mesh, device="meta", reckon_step=False,
                                 grad_sync_once=True)
            got = dict(rec["memory"])
            want = _reference_grad_sync_once_bytes(arch, shape, mesh_name)
            assert got.pop("argument_size_in_bytes") == sum(want.values())
            assert got == want, (shape, mesh_name)


def test_grad_sync_once_meta_step_and_cli(tmp_path, monkeypatch):
    """The meta step of the zero trainer reckons the microbatched step's
    FLOPs (the same work); the CLI passes the flag on (its run at smoke
    size here)."""
    plain = dryrun.run_one("qwen2.5-3b", "train_4k", device="meta", smoke=True)
    once = dryrun.run_one("qwen2.5-3b", "train_4k", device="meta", smoke=True,
                          grad_sync_once=True)
    assert once["status"] == plain["status"] == "ok"
    assert once["microbatches"] == plain["microbatches"] > 1
    assert once["flops"] == plain["flops"] and once["peak_bytes"] > 0
    seen = []
    inner = dryrun.run_one

    def smoke_run(*a, **k):
        seen.append(k["grad_sync_once"])
        return inner(*a, **dict(k, smoke=True))
    monkeypatch.setattr(dryrun, "run_one", smoke_run)
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "train_4k", "--mesh", "single",
                        "--device", "meta", "--grad-sync-once", "--out-dir",
                        str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen2.5-3b__train_4k__16x16.json").read_text())
    assert seen == [True] and rec["status"] == "ok" and rec["flops"] == once["flops"]
