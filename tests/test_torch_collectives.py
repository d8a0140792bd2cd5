"""The dry-run's collective bytes (``launch/collectives.py``) against the
reference's ``collective_bytes`` of the compiled JAX steps on the CPU.

All the reference's compiles run in one subprocess with 8 forced host
devices (the pattern of ``test_torch_zero_trainer.py``), at the smoke
configs, sequence 64 and global batch 8.

* Exact: the zero step (``make_zero_train_step``, 2 microbatches) on
  data-only meshes of 2 and 4 devices, jitted as the zero trainer's tests
  jit it (each rank holds the whole parameters), for qwen2.5-3b, a MoE
  (arctic-480b) and a recurrent stack (recurrentgemma-9b): its only
  collectives are the explicit psums of the fp32 gradients and the loss,
  and the port's ``collectives`` and ``collectives_body_once`` equal the
  reference's byte for byte.
* Band: the train (2 microbatches), prefill and decode steps of the
  llama-3.1-8b smoke config on 2 x 2 and 2 x 4 ("data", "model") meshes,
  lowered as the reference's ``run_one`` lowers them (its in- and
  out-shardings).  XLA's partitioner chooses those collectives; the port
  reckons a PyTorch execution of the same placement.  The all-gathers, the
  reductions (all-reduce and reduce-scatter together: XLA:CPU lowers a
  gradient's reduce-scatter to an all-reduce and a slice) and the total must
  lie within ``BAND`` of XLA's, except the share named in ``MEASURED``,
  held at their measured ratio.

``python tests/test_torch_collectives.py`` prints the ratios of these cases
and of every smoke id's train, prefill and decode steps on the 2 x 2 mesh;
with ``--production`` it prints the GB a device of every ok assigned (arch,
shape) on the two production meshes instead, as the dry-run records them.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.launch import collectives, dryrun
from repro_torch.launch.mesh import NamedMesh, make_production_mesh
from repro_torch.launch.shapes import INPUT_SHAPES, abstract_params
from repro_torch.launch import sharding as shd
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SEQ, BATCH, MICRO = 64, 8, 2
BAND = 2.0
ZERO_ARCHS = ("qwen2.5-3b", "arctic-480b", "recurrentgemma-9b")
BAND_ARCH = "llama-3.1-8b"
REFERENCE_KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute"}
# (kind, mesh, share): the measured ratios (collectives, body once) of a
# share that misses the band, and the collective XLA inserts that the rules
# do not
MEASURED = {
    # XLA keeps the decode token's residual sharded over "model" on d between
    # blocks: it all-gathers the (b, d) activation before each column-parallel
    # product (and all-reduces the norms' sums); the port keeps it whole
    ("decode", "2x4", "all-gather"): (0.25, 0.2222),
}


def _zero_case(arch, n):
    return {"arch": arch, "kind": "train", "seq": SEQ, "batch": BATCH, "microbatches": MICRO,
            "mesh": [n], "names": ["data"], "zero": True}


def _case(arch, kind, mesh, microbatches=1):
    return {"arch": arch, "kind": kind, "seq": SEQ, "batch": BATCH,
            "microbatches": microbatches, "mesh": list(mesh), "names": ["data", "model"],
            "zero": False}


ZERO_CASES = [_zero_case(a, n) for a in ZERO_ARCHS for n in (2, 4)]
BAND_CASES = [_case(BAND_ARCH, kind, mesh, MICRO if kind == "train" else 1)
              for kind in ("train", "prefill", "decode") for mesh in ((2, 2), (2, 4))]

_JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.launch import sharding as shd
    from repro.launch.dryrun import collective_bytes
    from repro.launch.shapes import (abstract_params, decode_inputs, make_step_fn,
                                     prefill_inputs, train_inputs)
    from repro.launch.zero_trainer import make_zero_train_step
    from repro.models.model import build_model
    from repro.training import AdamWConfig, init_opt_state

    def compiled(case):
        cfg = get_config(case["arch"], smoke=True)
        kind, seq, batch, mb = case["kind"], case["seq"], case["batch"], case["microbatches"]
        n = int(np.prod(case["mesh"]))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(case["mesh"]), tuple(case["names"]))
        params = abstract_params(cfg)
        if case["zero"]:
            step = jax.jit(make_zero_train_step(build_model(cfg), AdamWConfig(), mesh,
                                                microbatches=mb))
            opt = jax.eval_shape(init_opt_state, params)
            return cfg, step.lower(params, opt, train_inputs(cfg, seq, batch)).compile()
        # as repro.launch.dryrun.run_one lowers the step, on this mesh
        p_specs = shd.param_specs(mesh, params, mode="serve" if kind == "decode" else "train")
        with jax.set_mesh(mesh):
            if kind == "train":
                opt = jax.eval_shape(init_opt_state, params)
                o_specs = shd.opt_state_specs(mesh, opt, p_specs)
                step = jax.jit(make_step_fn(cfg, "train", microbatches=mb),
                               in_shardings=(p_specs, o_specs, shd.batch_spec(mesh, cfg)),
                               out_shardings=(p_specs, o_specs, None), donate_argnums=(0, 1))
                return cfg, step.lower(params, opt, train_inputs(cfg, seq, batch)).compile()
            if kind == "prefill":
                step = make_step_fn(cfg, "prefill")
                inputs = prefill_inputs(cfg, seq, batch)
                b_specs = {k: v for k, v in shd.batch_spec(mesh, cfg).items() if k in inputs}
                c_specs = shd.cache_specs(mesh, jax.eval_shape(step, params, inputs)[1], batch)
                step = jax.jit(step, in_shardings=(p_specs, b_specs),
                               out_shardings=(None, c_specs))
                return cfg, step.lower(params, inputs).compile()
            inputs = decode_inputs(cfg, seq, batch)
            c_specs = shd.cache_specs(mesh, inputs["caches"], batch)
            step = jax.jit(make_step_fn(cfg, "decode"),
                           in_shardings=(p_specs, shd.token_spec(mesh, batch), c_specs),
                           out_shardings=(None, c_specs), donate_argnums=(2,))
            return cfg, step.lower(params, inputs["token"], inputs["caches"]).compile()

    out = []
    for case in json.loads(sys.argv[1]):
        cfg, c = compiled(case)
        hlo = c.as_text()
        trips = max(cfg.pattern_periods, cfg.num_layers if cfg.enc_layers else 1,
                    1) * max(case["microbatches"], 1)
        out.append({"collectives": collective_bytes(hlo, trips),
                    "collectives_body_once": collective_bytes(hlo, 1), "trips": trips})
    print(json.dumps(out))
""")


def reference(cases):
    """The reference's records of ``cases``, compiled in one subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, json.dumps(cases)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def port(case):
    cfg = configs.get_config(case["arch"], smoke=True)
    mesh = NamedMesh.of(case["mesh"], case["names"])
    return collectives.collective_bytes(cfg, case["kind"], case["seq"], case["batch"], mesh,
                                        microbatches=case["microbatches"],
                                        grad_sync_once=case["zero"])


def shares(rec):
    """All-gathers, reductions (all-reduce + reduce-scatter) and the total."""
    return {"all-gather": rec.get("all-gather", 0),
            "reductions": rec.get("all-reduce", 0) + rec.get("reduce-scatter", 0),
            "total": sum(rec.values())}


def ratios(got, want):
    g, w = shares(got), shares(want)
    return {k: g[k] / w[k] if w[k] else float("inf") if g[k] else 1.0 for k in g}


@pytest.fixture(scope="module")
def references():
    cases = ZERO_CASES + BAND_CASES
    return {json.dumps(c, sort_keys=True): r for c, r in zip(cases, reference(cases))}


def _ref(references, case):
    return references[json.dumps(case, sort_keys=True)]


@pytest.mark.parametrize("case", ZERO_CASES, ids=lambda c: f"{c['arch']}-{c['mesh'][0]}")
def test_zero_step_equals_the_reference_exactly(references, case):
    """One all-reduce of 4 bytes a parameter (the fp32 gradients) and one of
    the 4-byte loss, outside every loop: byte for byte the reference's."""
    want = _ref(references, case)
    full, once, trips = port(case)
    assert full == want["collectives"] and once == want["collectives_body_once"]
    assert trips == want["trips"]
    cfg = configs.get_config(case["arch"], smoke=True)
    numel = sum(leaf.nbytes // leaf.dtype.itemsize
                for leaf in shd.param_leaves(abstract_params(cfg), cfg).values())
    assert full == {"all-reduce": 4 * numel + 4}


@pytest.mark.parametrize("case", BAND_CASES,
                         ids=lambda c: f"{c['kind']}-{'x'.join(map(str, c['mesh']))}")
def test_gspmd_steps_fall_within_the_band(references, case):
    """The train, prefill and decode steps within ``BAND`` of XLA's counts,
    share by share, with the reference's loop trip count; a share of
    ``MEASURED`` at its measured ratio."""
    want = _ref(references, case)
    full, once, trips = port(case)
    assert trips == want["trips"] and set(full) <= REFERENCE_KINDS
    mesh = "x".join(map(str, case["mesh"]))
    for rec, ref in ((full, want["collectives"]), (once, want["collectives_body_once"])):
        for share, r in ratios(rec, ref).items():
            known = MEASURED.get((case["kind"], mesh, share))
            if known is not None:
                assert r == pytest.approx(known[rec is once], rel=1e-3), (share, r)
            else:
                assert 1 / BAND <= r <= BAND, (share, r, rec, ref)


IDENTITY_CASES = [("llama-3.1-8b", "train", 2), ("recurrentgemma-9b", "train", 1),
                  ("whisper-tiny", "prefill", 1), ("mamba2-130m", "decode", 1),
                  ("arctic-480b", "train", 4), ("internvl2-26b", "prefill", 1)]


@pytest.mark.parametrize("arch,kind,micro", IDENTITY_CASES)
def test_collectives_are_the_outside_plus_trips_times_the_loop(arch, kind, micro):
    """``collectives`` = outside + trips x loop and ``collectives_body_once``
    = outside + loop, kind by kind; trips by the reference's formula; on a
    1 x 1 mesh nothing at all."""
    cfg = configs.get_config(arch, smoke=True)
    mesh = NamedMesh.of((2, 4), ("data", "model"))
    full, once, trips = collectives.collective_bytes(cfg, kind, SEQ, BATCH, mesh,
                                                     microbatches=micro)
    outside, loop, t = collectives.split(cfg, kind, SEQ, BATCH, mesh, microbatches=micro)
    want_trips = max(cfg.pattern_periods, cfg.num_layers if cfg.enc_layers else 1, 1) * micro
    assert trips == t == want_trips
    assert full and set(full) <= REFERENCE_KINDS
    for k in collectives.KINDS:
        assert full.get(k, 0) == outside[k] + trips * loop[k]
        assert once.get(k, 0) == outside[k] + loop[k]
    one = NamedMesh.of((1, 1), ("data", "model"))
    assert collectives.collective_bytes(cfg, kind, SEQ, BATCH, one, microbatches=micro) == (
        {}, {}, want_trips)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_one_sync_a_step_at_full_size(arch):
    """At full size on both production meshes, outside its loops the zero
    step all-reduces 4 bytes a parameter at its "model" placement once for
    each batch axis, plus the 4-byte loss, and nothing else."""
    cfg = configs.get_config(arch)
    leaves = shd.param_leaves(abstract_params(cfg), cfg)
    fp32 = {k: shd.Leaf(leaf.shape, torch.float32) for k, leaf in leaves.items()}
    seq, batch, _ = INPUT_SHAPES["train_4k"]
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        whole = {k: collectives._strip(s, ("pod", "data"))
                 for k, s in shd.param_specs(mesh, leaves, "serve").items()}
        bucket = shd.per_device_bytes(fp32, whole, mesh)
        micro = dryrun.clip_microbatches(cfg.train_microbatches,
                                         batch // dryrun.data_shards(mesh))
        outside, _, _ = collectives.split(cfg, "train", seq, batch, mesh, microbatches=micro,
                                          grad_sync_once=True)
        axes = 2 if multi else 1
        assert {k: v for k, v in outside.items() if v} == {"all-reduce": axes * bucket + 4}


def production_table():
    """GB a device by kind of every ok (arch, shape) on 16x16 and 2x16x16, as
    ``dryrun --all --device meta`` records them (``run_one`` without the meta
    step: the collectives do not need it)."""
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            row = {}
            for multi in (False, True):
                rec = dryrun.run_one(arch, shape, make_production_mesh(multi_pod=multi),
                                     device="meta", reckon_step=False)
                if rec["status"] == "ok":
                    row[rec["mesh"]] = {k: round(v / 1e9, 3)
                                        for k, v in rec["collectives"].items()}
            if row:
                print(json.dumps({"arch": arch, "shape": shape, **row}), flush=True)


def main():
    if "--production" in sys.argv:
        return production_table()
    cases = BAND_CASES + [_case(a, k, (2, 2)) for a in ASSIGNED_ARCHS
                          for k in ("train", "prefill", "decode")]
    for case, want in zip(cases, reference(cases)):
        full, _, _ = port(case)
        r = ratios(full, want["collectives"])
        print(json.dumps({"arch": case["arch"], "kind": case["kind"],
                          "mesh": "x".join(map(str, case["mesh"])),
                          "microbatches": case["microbatches"],
                          "ratio": {k: round(v, 3) for k, v in r.items()},
                          "port": full, "xla": want["collectives"]}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
