"""The one traffic generator: it reads a mix's data file
(``portbench/traffic/<name>.json``) and makes, from the seed, the query
texts, the warm set that fills the bank in set-up, and, for an open loop,
the due time of every request.

Query kinds:

* ``workload`` — a chat stream over the 8,000 topics x 6 intents of the
  frozen generator (``questions.py``), cells drawn Zipf(``alpha``) by rank,
  a cell's last text repeated with probability ``exact_repeat``, paraphrased
  otherwise.  The warm set is the stream's first ``warm_set`` queries, the
  window's queries the ones after: the same popular cells, disjoint draws.
* ``unique`` — fresh texts no bank entry can match: random pseudo-words of
  three syllables (a million of them), ``words`` long, no text twice.

Lengths and arrival gaps come from a fixed stream and are only put in
another order by the seed, so every seed draws from the same work; a
window serves the prefix of it that fits, which differs a little from seed
to seed.
"""
from __future__ import annotations

import numpy as np

from . import questions as q

SIZES_SEED = 20_240_617          # the fixed stream of lengths and gaps
_CONS = "bcdfghjklmnprstvwxyz"
_VOWELS = "aeiou"
SYLLABLES = [c + v for c in _CONS for v in _VOWELS]


class ZipfStream:
    """Cells by Zipf rank over a permutation, rendered as the program's
    ``WorkloadGenerator`` renders them.  The popular cells and the ranks
    drawn come from the fixed stream, so every seed asks for the same cells
    as often; the seed orders the window's draws and renders the texts."""

    def __init__(self, alpha: float, exact_repeat: float, seed: int):
        self.base = np.random.default_rng([SIZES_SEED, 2])
        self.rng = np.random.default_rng(seed)
        n = len(q._TOPICS) * len(q._INTENTS)
        p = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
        self.p = p / p.sum()
        self.cells = self.base.permutation(n)
        self.exact = exact_repeat
        self.seen: dict = {}

    def sample(self, n: int, shuffle: bool = False):
        """[(text, topic, intent)] of the next ``n`` queries (their ranks put
        in the seed's order when ``shuffle``)."""
        ranks = self.base.choice(len(self.p), size=n, p=self.p)
        if shuffle:
            ranks = self.rng.permutation(ranks)
        out = []
        for r in ranks:
            cell = int(self.cells[r])
            t, i = divmod(cell, len(q._INTENTS))
            intent = q._INTENTS[i]
            if cell in self.seen and self.rng.random() < self.exact:
                text = self.seen[cell]
            else:
                text = q._render(self.rng, t, intent)
                self.seen[cell] = text
            out.append((text, t, intent))
        return out


def unique_lengths(spec: dict, n: int, seed: int, part: int = 0) -> np.ndarray:
    """Word counts: a log-normal around ``median`` words, ``sigma`` wide,
    clipped to [min, max]; the same multiset for every seed."""
    base = np.random.default_rng([SIZES_SEED, part])
    w = np.exp(base.normal(np.log(spec["median"]), spec["sigma"], size=n))
    w = np.clip(np.round(w), spec["min"], spec["max"]).astype(np.int64)
    return np.random.default_rng(seed).permutation(w)


def unique_texts(spec: dict, n: int, seed: int, part: int = 0, seen=None):
    """``n`` texts of ``unique_lengths`` words, none in ``seen`` or twice."""
    rng = np.random.default_rng([seed, 1, part])
    seen = set() if seen is None else seen
    out = []
    for k in unique_lengths(spec, n, seed, part):
        while True:
            syl = rng.integers(len(SYLLABLES), size=(int(k), 3))
            text = " ".join("".join(SYLLABLES[s] for s in row) for row in syl)
            if text not in seen:
                break
        seen.add(text)
        out.append(text)
    return out


def due_offsets(rate: float, n: int, seed: int) -> np.ndarray:
    """Seconds after the window opens at which each of ``n`` requests is
    due: Poisson gaps at ``rate`` from the fixed stream, reordered by seed."""
    gaps = np.random.default_rng(SIZES_SEED + 1).exponential(1.0, size=n)
    return np.cumsum(np.random.default_rng(seed).permutation(gaps)) / rate


class Traffic:
    """One mix, made from ``seed``: ``warm`` [(query, response)] for the
    bank, ``warmup`` texts served before the window, ``stream`` texts for
    the window, and ``due`` offsets (open loop)."""

    def __init__(self, spec: dict, seed: int, seconds: float):
        self.spec = spec
        self.loop = spec["loop"]
        qs = spec["queries"]
        n = int(spec.get("stream", 8192))
        warmup = int(spec.get("warmup", 64))
        if self.loop == "open":
            n = max(n, int(spec["rate_per_s"] * (seconds + 5) * 1.5) + 64)
        if qs["kind"] == "workload":
            z = ZipfStream(qs["alpha"], qs["exact_repeat"], seed)
            warm = z.sample(int(spec.get("warm_set", 0)))
            self.warm = [(t, q.synthesize_response(t, top, intent)) for t, top, intent in warm]
            texts = [t for t, _, _ in z.sample(warmup + n, shuffle=True)]
        elif qs["kind"] == "unique":
            self.warm = []
            seen: set = set()
            texts = unique_texts(qs, warmup, seed, 1, seen) + unique_texts(qs, n, seed, 0, seen)
        else:
            raise ValueError(f"unknown query kind {qs['kind']!r}")
        self.warmup, self.stream = texts[:warmup], texts[warmup:]
        self.due = due_offsets(spec["rate_per_s"], n, seed) if self.loop == "open" else None
