"""Multi-agent debate protocol (paper §4.2.2 + Appendix B, after ChatEval);
a copy of ``src/repro/eval/debate.py`` (host numpy, the same RNG draws).

Three personas, two rounds, fixed order (factual -> UX -> relevance).  Each
persona emits verdict A / B / AB with a margin-based tie band; in round 2
each referee sees the history and is pulled toward the running consensus
(the paper's "must consider other referees' judgements"), but keeps its own
evidence — majority verdict over the final round decides.

Blinding + order randomisation: response order is shuffled per item with a
seeded RNG, mirroring the paper's shuffled side-by-side presentation.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from .judge import PERSONAS, persona_score

TIE_BAND = 0.03          # score margin below which a persona votes AB
HISTORY_PULL = 0.35      # round-2 consensus weight


@dataclasses.dataclass
class DebateResult:
    verdict: str                 # "A" | "B" | "AB"
    votes: List[str]             # final-round persona votes
    margins: List[float]


def _vote(margin: float) -> str:
    if abs(margin) <= TIE_BAND:
        return "AB"
    return "A" if margin > 0 else "B"


def run_debate(query: str, resp_a: str, resp_b: str, loglik_a: float,
               loglik_b: float, *, rng: np.random.Generator) -> DebateResult:
    # blinding: randomly swap the presentation order
    swap = bool(rng.integers(2))
    ra, rb = (resp_b, resp_a) if swap else (resp_a, resp_b)
    la, lb = (loglik_b, loglik_a) if swap else (loglik_a, loglik_b)

    margins = []
    votes: List[str] = []
    # round 1: independent
    for p in PERSONAS:
        m = persona_score(p, la, query, ra) - persona_score(p, lb, query, rb)
        margins.append(m)
    # round 2: sees history (consensus pull), sequential order per paper
    consensus = float(np.mean(margins))
    final_margins = []
    for i, _p in enumerate(PERSONAS):
        m2 = (1 - HISTORY_PULL) * margins[i] + HISTORY_PULL * consensus
        final_margins.append(m2)
        votes.append(_vote(m2))
    # majority verdict
    counts = {v: votes.count(v) for v in ("A", "B", "AB")}
    verdict = max(counts, key=lambda v: (counts[v], v == "AB"))
    if swap:  # unblind
        verdict = {"A": "B", "B": "A", "AB": "AB"}[verdict]
        votes = [{"A": "B", "B": "A", "AB": "AB"}[v] for v in votes]
        final_margins = [-m for m in final_margins]
    return DebateResult(verdict, votes, final_margins)


def debate_batch(queries: Sequence[str], resp_a: Sequence[str],
                 resp_b: Sequence[str], logliks_a: Sequence[float],
                 logliks_b: Sequence[float], seed: int = 0) -> List[DebateResult]:
    rng = np.random.default_rng(seed)
    return [run_debate(q, a, b, la, lb, rng=rng)
            for q, a, b, la, lb in zip(queries, resp_a, resp_b,
                                       logliks_a, logliks_b)]


def verdict_shares(results: List[DebateResult]) -> dict:
    n = max(len(results), 1)
    return {v: sum(r.verdict == v for r in results) / n for v in ("A", "B", "AB")}
