"""Cache-eviction policy study, the paper's §6.2 open question (counterpart
of the reference's ``examples/cache_policy_study.py``).

Replays the same Zipfian workload against FIFO / LRU / LFU banks much smaller
than the topic universe and reports hit rates.  A beyond-paper extension:
the paper ships append-only and defers eviction policies.

  PYTHONPATH=src python -m repro_torch.examples.cache_policy_study [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List

import torch

from repro_torch.core import cache as cache_lib
from repro_torch.data import WorkloadGenerator
from repro_torch.device import resolve_device
from repro_torch.models.embedder import encode, init_embedder, tiny_embedder_config
from repro_torch.tokenizer import HashWordTokenizer
from repro_torch.training.embedder_train import train_embedder

VOCAB = 8192
THRESHOLD = 0.7


def run_policy(policy: str, embs: torch.Tensor, capacity: int = 96) -> List[bool]:
    """Each row of ``embs`` (N, D) looked up in turn against a bank of
    ``capacity`` rows under ``policy``: a hit (top-1 score >= THRESHOLD)
    is touched, a miss inserted.  Returns the hit flag of each row; the
    reference returns their mean."""
    cfg = cache_lib.CacheConfig(capacity=capacity, dim=embs.shape[1], policy=policy, topk=1,
                                max_query_tokens=4, max_response_tokens=4)
    dev = embs.device
    state = cache_lib.init_cache(cfg, dev)
    z = torch.zeros(4, dtype=torch.int32, device=dev)
    m = torch.ones(4, dtype=torch.float32, device=dev)
    hits = []
    for i in range(embs.shape[0]):
        scores, idx = cache_lib.lookup(state, cfg, embs[i][None])
        hit = float(scores[0, 0]) >= THRESHOLD
        if hit:
            state = cache_lib.touch(state, cfg, idx[0, :1])
        else:
            state = cache_lib.insert(state, cfg, embs[i], z, m, z, m)
        hits.append(hit)
    return hits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tok = HashWordTokenizer(VOCAB)
    ecfg = tiny_embedder_config(VOCAB)
    # seed: ok example, deterministic init as the reference's PRNGKey(0)
    eparams = init_embedder(ecfg, torch.Generator(device=dev).manual_seed(0), dev)
    print("training embedder...")
    eparams, _ = train_embedder(eparams, ecfg, tok, steps=50, batch=16)
    wl = WorkloadGenerator(profile="lmsys", seed=0)  # seed: ok example, reproducible workload
    queries = [q.text for q in wl.sample(500)]
    t, msk = tok.encode_batch(queries, 32)
    with torch.no_grad():
        embs = encode(eparams, torch.as_tensor(t).to(dev), torch.as_tensor(msk).to(dev), ecfg)

        print(f"workload: 500 queries, cache capacity 96, threshold {THRESHOLD}")
        for policy in ("fifo", "lru", "lfu"):
            hits = run_policy(policy, embs)
            print(f"  {policy.upper():5s} hit rate: {sum(hits) / len(hits):.1%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
