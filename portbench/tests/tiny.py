"""A benchmark root at a size the CPU runs in seconds: the real
``BENCHMARK.json``'s metrics, its metric readers copied by name, and one
small configuration (a MoE big model, a dense small one with the prefix
path, the tiny embedder) under a closed and an open mix."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL = {"name": "small", "family": "dense", "num_layers": 2, "d_model": 64, "num_heads": 4,
         "num_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 512,
         "block_pattern": ["attn"], "qkv_bias": True, "mlp_type": "swiglu",
         "norm_type": "rmsnorm", "rope_theta": 10000.0, "sliding_window": 0,
         "attention_impl": "xla_flash", "flash_block_q": 32, "flash_block_k": 32,
         "max_seq_len": 512, "dtype": "float32"}
BIG = {"name": "big", "family": "moe", "num_layers": 2, "d_model": 64, "num_heads": 4,
       "num_kv_heads": 2, "head_dim": 16, "d_ff": 96, "vocab_size": 512,
       "block_pattern": ["moe"], "num_experts": 4, "experts_per_token": 2, "moe_d_ff": 96,
       "capacity_factor": 1.25, "moe_group_size": 2048, "qkv_bias": False,
       "mlp_type": "swiglu", "norm_type": "layernorm", "rope_theta": 10000.0,
       "sliding_window": 0, "attention_impl": "auto", "max_seq_len": 512, "dtype": "float32"}
EMB = {"name": "emb", "family": "encoder", "num_layers": 2, "d_model": 64, "num_heads": 4,
       "num_kv_heads": 4, "head_dim": 16, "d_ff": 128, "vocab_size": 512, "mlp_type": "gelu",
       "norm_type": "layernorm", "rope_theta": 10000.0, "dtype": "float32", "max_seq_len": 128}
SERVING = {"bank_rows": 4096, "max_new_tokens": 8, "max_batch": 8, "max_wait_s": 0.01,
           "max_query_len": 64, "embedder_steps": 4, "embedder_batch": 8, "embedder_lr": 3e-4,
           "tweak_threshold": 0.7}
TRAFFIC = {
    "tiny-closed": {"loop": "closed", "clients": 16,
                    "queries": {"kind": "workload", "alpha": 0.85, "exact_repeat": 0.04},
                    "warm_set": 256, "warmup": 16, "stream": 1024},
    "tiny-open": {"loop": "open", "rate_per_s": 40.0, "arrivals": "poisson",
                  "queries": {"kind": "unique", "min": 6, "median": 14, "sigma": 0.7, "max": 62},
                  "warm_set": 0, "warmup": 16, "stream": 256},
}
LIMITS = {"embed_err": 1e-4, "score_err": 1e-4, "top1_err": 1e-4, "mismatch": 0,
          "small_gap": 1e-3, "big_gap": 1e-3, "small_gap_mean": 1e-4, "big_gap_mean": 1e-4}


def make_root(tmp: Path) -> Path:
    """A benchmark root under ``tmp``: the tiny configuration, both mixes,
    every metric reader of the real benchmark."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp / "portbench"
    for d in ("configs", "traffic", "limits"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "portbench" / "metrics", pb / "metrics", dirs_exist_ok=True)
    cfg = dict(BIG, source="https://example.org/tiny", small=SMALL, embedder=EMB,
               serving=SERVING)
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    cells = []
    for name, t in TRAFFIC.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(t))
        (pb / "limits" / f"tiny.{name}.json").write_text(json.dumps(LIMITS))
        cells.append({"name": f"tiny.{name}", "config": "tiny", "traffic": name, "chips": 1,
                      "why": "a CPU-sized cell"})
    closed, opened = ["tiny.tiny-closed"], ["tiny.tiny-open"]
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = opened if m["name"].startswith("lat_") else closed
    for m in spec["per_layer"]:
        m["workloads"] = opened if m["name"].endswith(".open") else closed
    spec["configs"] = [{"name": "tiny", "source": "https://example.org/tiny",
                        "file": "portbench/configs/tiny.json", "reduced": [], "why": "tiny"}]
    spec["workloads"] = cells
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
