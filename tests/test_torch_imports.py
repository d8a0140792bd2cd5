"""The port stands alone: no file of ``src/repro_torch`` or the chip scripts
imports JAX or the ``repro`` package; default-device entry points refuse to
run without a card; a missing ``nvcc`` raises instead of falling back."""
import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import jax_params_to_torch
from repro_torch.device import resolve_device
from repro_torch.kernels import build, launch_counts, reset_launch_counts
from repro_torch.launch.mesh import make_cache_mesh
from repro_torch.launch.serve import build_embedder, build_engine, build_replica_group
from repro_torch.models.embedder import tiny_embedder_config
from _torch_threads import torch_threads  # noqa: F401 (autouse: a share of the cores)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    names = {f.relative_to(ROOT / "src").as_posix() for f in files[:-1]}
    configs = {f"repro_torch/configs/{m}.py" for m in (
        "qwen2_5_3b", "deepseek_coder_33b", "h2o_danube_1_8b", "nemotron_4_340b",
        "whisper_tiny", "internvl2_26b")}
    assert {"repro_torch/core/distributed.py", "repro_torch/launch/mesh.py",
            "repro_torch/serving/scheduler.py", "repro_torch/serving/continuous.py",
            "repro_torch/models/encdec.py", "repro_torch/launch/shapes.py",
            "repro_torch/launch/sharding.py", "repro_torch/launch/dryrun.py",
            "repro_torch/kernels/meta.py", "repro_torch/analysis/__init__.py",
            "repro_torch/analysis/registry.py", "repro_torch/analysis/lint.py",
            "repro_torch/analysis/contracts.py", "repro_torch/models/sharding_utils.py",
            "repro_torch/launch/zero_trainer.py"} <= names
    assert configs <= names
    for mod in ("repro_torch.core.distributed", "repro_torch.launch.mesh",
                "repro_torch.models.encdec", "repro_torch.launch.shapes",
                "repro_torch.launch.sharding", "repro_torch.launch.dryrun",
                "repro_torch.kernels.meta", "repro_torch.analysis",
                "repro_torch.analysis.registry", "repro_torch.analysis.lint",
                "repro_torch.analysis.contracts", "repro_torch.models.sharding_utils",
                "repro_torch.launch.zero_trainer",
                *(n.removesuffix(".py").replace("/", ".") for n in sorted(configs))):
        importlib.import_module(mod)
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        build_engine(model="serve-tiny")
    with pytest.raises(RuntimeError):
        build_embedder()
    with pytest.raises(RuntimeError):
        build_engine(model="serve-tiny", band=0.1)
    with pytest.raises(RuntimeError):
        build_replica_group(2, model="serve-tiny")
    with pytest.raises(ValueError, match="CUDA devices"):
        make_cache_mesh(2)
    params, _ = build_embedder(device="cpu")
    assert params["embed"].device.type == "cpu"


def test_converter_needs_a_card_by_default():
    """A converted checkpoint lands on the card unless the caller asks for
    the CPU, so an engine built from it never drops to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    ecfg = tiny_embedder_config(64)
    flat = {"embed": np.zeros((ecfg.vocab_size, ecfg.d_model), np.float32),
            "final_norm/scale": np.ones(ecfg.d_model, np.float32)}
    for name, w in (("attn/w_q", (ecfg.d_model, ecfg.num_heads, ecfg.resolved_head_dim)),
                    ("attn/w_k", (ecfg.d_model, ecfg.num_kv_heads, ecfg.resolved_head_dim)),
                    ("attn/w_v", (ecfg.d_model, ecfg.num_kv_heads, ecfg.resolved_head_dim)),
                    ("attn/w_o", (ecfg.num_heads, ecfg.resolved_head_dim, ecfg.d_model)),
                    ("mlp/w_up", (ecfg.d_model, ecfg.d_ff)),
                    ("mlp/w_down", (ecfg.d_ff, ecfg.d_model))):
        flat["scan/" + name] = np.zeros((ecfg.num_layers,) + w, np.float32)
    for norm in ("norm1", "norm2"):
        flat[f"scan/{norm}/scale"] = np.ones((ecfg.num_layers, ecfg.d_model), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jax_params_to_torch(flat, ecfg)
    params = jax_params_to_torch(flat, ecfg, device="cpu")
    assert params["embed"].device.type == "cpu" and len(params["layers"]) == ecfg.num_layers


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_launch_counts_reset():
    reset_launch_counts()
    assert launch_counts() == {"flash_attention": 0, "decode_attention": 0, "cosine_topk": 0,
                               "decode_attention_block": 0, "paged_decode_attention": 0,
                               "paged_decode_attention_block": 0, "cosine_topk_gather": 0}


SLICE_2 = ("serving/scheduler.py", "serving/paged_kv.py", "serving/continuous.py",
           "kernels/paged_attention/ops.py", "kernels/paged_attention/ref.py")


@pytest.mark.parametrize("rel", SLICE_2)
def test_slice_2_modules_stand_alone(rel):
    """Each module of the second slice imports and is among the files the
    import check above walks; the CUDA sources it launches are in csrc."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in _port_files()
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    importlib.import_module("repro_torch." + rel[:-3].replace("/", "."))


SLICE_3 = ("core/index.py", "core/cache.py", "core/router.py", "checkpoint/convert.py",
           "kernels/cosine_topk/ops.py", "kernels/cosine_topk/ref.py")


@pytest.mark.parametrize("rel", SLICE_3)
def test_slice_3_modules_stand_alone(rel):
    """The IVF slice's modules import without JAX or the JAX package; the
    shortlist kernel's source has the entry point its wrapper binds."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in _port_files()
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    importlib.import_module("repro_torch." + rel[:-3].replace("/", "."))
    src = ROOT / "src" / "repro_torch" / "csrc" / "cosine_topk_gather.cu"
    assert "int cosine_topk_gather_launch(" in src.read_text()
    assert "cosine_topk_gather_launch" in build.SIGNATURES


def test_new_kernel_sources_and_signatures():
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    for src in ("decode_attention_block.cu", "paged_attention.cu", "attention_panel.cuh"):
        assert (csrc / src).exists()
    for name in ("decode_attention_block_launch", "paged_decode_attention_launch",
                 "paged_decode_attention_block_launch"):
        assert name in build.SIGNATURES
        assert any(f"int {name}(" in f.read_text() for f in csrc.glob("*.cu"))


SLICE_4 = ("training/__init__.py", "training/optimizer.py", "training/embedder_train.py",
           "training/reranker_train.py", "models/reranker.py", "core/baseline.py",
           "eval/__init__.py", "eval/metrics.py")


@pytest.mark.parametrize("rel", SLICE_4)
def test_slice_4_modules_stand_alone(rel):
    """The training, cascade and baseline slice imports without JAX or the
    JAX package (its metrics are a copy, not an import)."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in _port_files()
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    name = rel[:-3].replace("/", ".").removesuffix(".__init__")
    importlib.import_module("repro_torch." + name)


SLICE_6 = ("models/transformer.py", "models/model.py", "kernels/flash_attention/ops.py",
           "kernels/flash_attention/ref.py", "training/trainer.py", "data/pretrain.py",
           "data/__init__.py", "checkpoint/checkpoint.py", "checkpoint/convert.py",
           "configs/__init__.py", "launch/train.py", "checkpoint/__init__.py",
           "eval/judge.py", "eval/debate.py")


@pytest.mark.parametrize("rel", SLICE_6)
def test_slice_6_modules_stand_alone(rel):
    """LM training and the judge-and-debate evaluation import without JAX or
    the JAX package (the debate, features and token stream are copies)."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in _port_files()
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    name = rel[:-3].replace("/", ".").removesuffix(".__init__")
    importlib.import_module("repro_torch." + name)


def test_train_cli_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])


def test_dry_run_needs_a_card_unless_it_only_reckons():
    """``run_one`` runs the one-card plan on the card by default and raises
    without one before reckoning; ``device="meta"`` only reckons."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import dryrun
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_one("mamba2-130m", "long_500k")
    rec = dryrun.run_one("mamba2-130m", "long_500k", device="meta", reckon_step=False)
    assert rec["status"] == "ok" and "card" not in rec


SLICE_8 = ("models/moe.py", "configs/arctic_480b.py", "configs/qwen3_moe_235b.py")


@pytest.mark.parametrize("rel", SLICE_8)
def test_slice_8_modules_stand_alone(rel):
    """The MoE block and its two configs import without JAX or the JAX
    package (the configs are copies of the reference's)."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in _port_files()
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    importlib.import_module("repro_torch." + rel[:-3].replace("/", "."))


SLICE_9 = ("models/ssm.py", "models/rglru.py", "models/transformer.py",
           "checkpoint/convert.py", "configs/mamba2_130m.py", "configs/recurrentgemma_9b.py")


@pytest.mark.parametrize("rel", SLICE_9)
def test_slice_9_modules_stand_alone(rel):
    """The recurrent blocks, the mixed-pattern stack, the converter of its
    layout and the two configs import without JAX or the JAX package (the
    configs are copies of the reference's)."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in _port_files()
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    importlib.import_module("repro_torch." + rel[:-3].replace("/", "."))


SLICE_12 = ("analysis/__init__.py", "analysis/registry.py", "analysis/lint.py",
            "analysis/contracts.py", "models/sharding_utils.py", "launch/zero_trainer.py")


@pytest.mark.parametrize("rel", SLICE_12)
def test_slice_12_modules_stand_alone(rel):
    """The analyzer, the sharding constraints and the zero trainer import
    without JAX or the JAX package (the lint's AST helpers are a copy)."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in _port_files()
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    name = rel[:-3].replace("/", ".").removesuffix(".__init__")
    importlib.import_module("repro_torch." + name)


def test_contracts_cli_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.analysis import contracts
    with pytest.raises(RuntimeError, match="device='cpu'"):
        contracts.main([])


SLICE_13 = ("examples/__init__.py", "examples/quickstart.py", "examples/serve_e2e.py",
            "examples/cache_policy_study.py", "core/tweak.py")


@pytest.mark.parametrize("rel", SLICE_13)
def test_slice_13_modules_stand_alone(rel):
    """The reference's examples on the port, and the tensor assembly of
    TWEAK prompts, import without JAX or the JAX package."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in _port_files()
    assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    name = rel[:-3].replace("/", ".").removesuffix(".__init__")
    importlib.import_module("repro_torch." + name)


@pytest.mark.parametrize("name", ["quickstart", "serve_e2e", "cache_policy_study"])
def test_examples_need_a_card_by_default(name):
    """Each example runs on the card unless ``--device cpu`` is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
