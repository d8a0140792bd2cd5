"""TweakLLM quickstart: the Figure-1 pipeline on five queries (counterpart of
the reference's ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.launch.serve import build_engine

DECISIONS = {0: "MISS->big LLM", 1: "TWEAK->small LLM", 2: "EXACT->cache"}
QUERIES = (
    "how do i learn python setup",                  # fresh -> MISS
    "how do i learn python setup",                  # repeat -> EXACT
    "what is the best way to learn python setup",   # paraphrase -> TWEAK
    "why is keto diet bad",                         # fresh -> MISS
    "what are the downsides of keto diet",          # paraphrase
)


def route_queries(eng, queries=QUERIES, max_new_tokens: int = 8):
    """Each query through ``eng`` alone, in order: a list of its meta dicts
    (``sim``, ``decision``, ...)."""
    out = []
    with torch.no_grad():
        for q in queries:
            _, meta = eng.handle_batch([q], max_new_tokens=max_new_tokens, collect_meta=True)
            out.append(meta[0])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    args = ap.parse_args(argv)

    print(f"building TweakLLM stack (tiny models, contrastive embedder) on {args.device}...")
    eng = build_engine(train_embedder_steps=40, capacity=256, device=args.device)
    for q, m in zip(QUERIES, route_queries(eng)):
        print(f"  sim={m['sim']:+.3f}  {DECISIONS[m['decision']]:18s}  {q!r}")
    s = eng.stats
    print(f"\nrouting: miss={s.miss} tweak={s.tweak} exact={s.exact}")
    print(f"cost: {s.cost:.0f} vs all-big {s.baseline_cost:.0f} "
          f"({s.cost/max(s.baseline_cost,1):.0%})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
