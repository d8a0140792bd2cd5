"""Frozen copy of the question texts of ``repro_torch/data/questions.py``,
kept here so that a change to the program cannot move the yardstick: the
topic-intent cells, their renderings, ``synthesize_response`` (the warm
set's answers) and ``QuestionPairGenerator`` (the embedder's training
triples: paraphrases, and hard negatives of flipped polarity or a swapped
entity).  The Zipfian stream over the cells is ``traffic.ZipfStream``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

# ------------------------------------------------------------ vocabulary

_SUBJECTS = ["python", "javascript", "rust", "linux", "keto", "vegan",
             "crypto", "stock", "guitar", "piano", "chess", "yoga",
             "marathon", "startup", "resume", "interview", "college",
             "visa", "credit", "mortgage", "garden", "puppy", "cat",
             "solar", "electric", "quantum", "welding", "pottery",
             "archery", "sailing", "beekeeping", "roofing", "plumbing",
             "calligraphy", "origami", "astronomy", "genealogy", "taxidermy",
             "falconry", "orienteering"]
_ASPECTS = ["training", "setup", "diet", "investing", "practice", "strategy",
            "routine", "application", "care", "installation", "tutorial",
            "maintenance", "course", "project", "certification", "budgeting",
            "scheduling", "insurance", "licensing", "troubleshooting"]
_QUALIFIERS = ["beginner", "advanced", "weekend", "professional", "budget",
               "intensive", "remote", "seasonal", "family", "competitive"]
# 40 x 20 x 10 = 8000 lexically distinctive topics: any two random topics
# share at most one content word, so the embedder can actually separate
# cells (the paper's datasets have this diversity for free).
_TOPICS = [f"{q} {s} {a}" for q in _QUALIFIERS for s in _SUBJECTS
           for a in _ASPECTS]

_FRAMES = {
    "how": ["how do i learn {t}", "what is the best way to learn {t}",
            "how can someone get started with {t}",
            "what are good steps to begin {t}",
            "how should a beginner approach {t}"],
    "why_good": ["why is {t} good", "what makes {t} worthwhile",
                 "what are the benefits of {t}", "why should i try {t}"],
    "why_bad": ["why is {t} bad", "what are the downsides of {t}",
                "what are the risks of {t}", "why should i avoid {t}"],
    "cost": ["how much does {t} cost", "what is the price of {t}",
             "is {t} expensive"],
    "time": ["how long does {t} take", "what is the time needed for {t}"],
    "compare": ["is {t} better than alternatives",
                "how does {t} compare to other options"],
}
_INTENTS = list(_FRAMES.keys())
_FILLERS = ["", "please tell me ", "i was wondering ", "quick question "]
_SUFFIX = ["", " exactly", " in practice", " these days", " for a beginner"]


@dataclasses.dataclass
class Query:
    text: str
    topic: int
    intent: str


def _render(rng: np.random.Generator, topic: int, intent: str) -> str:
    frame = _FRAMES[intent][rng.integers(len(_FRAMES[intent]))]
    q = frame.format(t=_TOPICS[topic])
    return (_FILLERS[rng.integers(len(_FILLERS))] + q
            + _SUFFIX[rng.integers(len(_SUFFIX))]).strip()


def synthesize_response(query_text: str, topic: int = -1, intent: str = "",
                        quality: str = "big") -> str:
    """Deterministic 'LLM response' for cache population.

    quality='big' emits a structured, detailed answer; 'small' a terse one —
    used by the judge protocol to reproduce the Fig-6 control (Small-direct
    clearly inferior to Big-direct).
    """
    topic_name = _TOPICS[topic] if topic >= 0 else "the subject"
    if quality == "big":
        return (f"here is a detailed answer about {topic_name} regarding"
                f" {intent or 'your question'}: first understand the"
                f" fundamentals of {topic_name}, then practice consistently,"
                f" track progress weekly, and consult expert resources."
                f" common pitfalls include rushing early stages and ignoring"
                f" feedback. summary: steady structured effort on"
                f" {topic_name} works best. (answering: {query_text})")
    return f"{topic_name}: it depends. try searching online about {query_text}."


class QuestionPairGenerator:
    """Labeled pairs in the spirit of Quora Question Pairs."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def duplicate_pair(self) -> Tuple[Query, Query]:
        t = int(self.rng.integers(len(_TOPICS)))
        intent = _INTENTS[self.rng.integers(len(_INTENTS))]
        return (Query(_render(self.rng, t, intent), t, intent),
                Query(_render(self.rng, t, intent), t, intent))

    def hard_negative_pair(self) -> Tuple[Query, Query]:
        """Shared words, different meaning (polarity flip or entity swap)."""
        t = int(self.rng.integers(len(_TOPICS)))
        if self.rng.random() < 0.5:  # polarity flip
            a = Query(_render(self.rng, t, "why_good"), t, "why_good")
            b = Query(_render(self.rng, t, "why_bad"), t, "why_bad")
        else:  # entity swap, same frame
            intent = _INTENTS[self.rng.integers(len(_INTENTS))]
            t2 = int(self.rng.integers(len(_TOPICS)))
            while t2 == t:
                t2 = int(self.rng.integers(len(_TOPICS)))
            a = Query(_render(self.rng, t, intent), t, intent)
            b = Query(_render(self.rng, t2, intent), t2, intent)
        return a, b

    def triple(self) -> Tuple[Query, Query, Query]:
        """(anchor, duplicate, hard-negative-of-anchor) for contrastive
        training: the negative shares the anchor's topic with flipped
        polarity, or shares its frame with a swapped entity."""
        t = int(self.rng.integers(len(_TOPICS)))
        if self.rng.random() < 0.5:
            ia, ineg = (("why_good", "why_bad")
                        if self.rng.random() < 0.5 else ("why_bad", "why_good"))
            a = Query(_render(self.rng, t, ia), t, ia)
            b = Query(_render(self.rng, t, ia), t, ia)
            n = Query(_render(self.rng, t, ineg), t, ineg)
        elif self.rng.random() < 0.5:
            intent = _INTENTS[self.rng.integers(len(_INTENTS))]
            t2 = self._near_topic(t)
            a = Query(_render(self.rng, t, intent), t, intent)
            b = Query(_render(self.rng, t, intent), t, intent)
            n = Query(_render(self.rng, t2, intent), t2, intent)
        else:  # same topic, different intent (cost vs time vs compare ...)
            ia, ib = self.rng.choice(len(_INTENTS), 2, replace=False)
            a = Query(_render(self.rng, t, _INTENTS[ia]), t, _INTENTS[ia])
            b = Query(_render(self.rng, t, _INTENTS[ia]), t, _INTENTS[ia])
            n = Query(_render(self.rng, t, _INTENTS[ib]), t, _INTENTS[ib])
        return a, b, n

    def _near_topic(self, t: int) -> int:
        """A topic sharing words with t (same subject or aspect) — the
        hardest entity-swap negative."""
        na, ns_ = len(_ASPECTS), len(_SUBJECTS)
        q, rem = divmod(t, ns_ * na)
        s, a = divmod(rem, na)
        if self.rng.random() < 0.5:
            a2 = (a + 1 + int(self.rng.integers(na - 1))) % na
            return q * ns_ * na + s * na + a2
        s2 = (s + 1 + int(self.rng.integers(ns_ - 1))) % ns_
        return q * ns_ * na + s2 * na + a

    def random_negative_pair(self) -> Tuple[Query, Query]:
        a = self._random_query()
        b = self._random_query()
        while b.topic == a.topic and b.intent == a.intent:
            b = self._random_query()
        return a, b

    def _random_query(self) -> Query:
        t = int(self.rng.integers(len(_TOPICS)))
        intent = _INTENTS[self.rng.integers(len(_INTENTS))]
        return Query(_render(self.rng, t, intent), t, intent)

    def generate(self, n: int, dup_frac: float = 0.5,
                 hard_frac: float = 0.25) -> List[Tuple[Query, Query, int]]:
        out = []
        for _ in range(n):
            r = self.rng.random()
            if r < dup_frac:
                a, b = self.duplicate_pair()
                out.append((a, b, 1))
            elif r < dup_frac + hard_frac:
                a, b = self.hard_negative_pair()
                out.append((a, b, 0))
            else:
                a, b = self.random_negative_pair()
                out.append((a, b, 0))
        return out
