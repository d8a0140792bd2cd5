"""LLM-as-judge: response scoring under a referee language model
(counterpart of ``src/repro/eval/judge.py``).

The paper uses GPT-4o referees; offline, the referee is one of OUR models —
each persona scores a (query, response) pair as a weighted blend of

  * length-normalised log-likelihood of the response under the referee LM
    conditioned on the query (the model-based quality signal), and
  * persona-specific measurable features (relevance overlap, structure,
    length appropriateness) matching each persona's stated focus (Table 2).

The debate protocol in ``debate.py`` composes three personas over two
rounds exactly as Appendix B specifies.  The feature functions and personas
are copies of the reference's; the scorer runs the port's training forward
under ``torch.no_grad()``, so its attention is the flash kernel's launch on
the card.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.tokenizer import HashWordTokenizer

LOGIT_BYTES = 1 << 30
"""Most bytes of fp32 logits one forward of the scorer makes: a batch is
scored in chunks of rows that keep (rows, S, V_padded) within it."""


def make_loglik_scorer(model: Model, params, tokenizer: HashWordTokenizer,
                       max_len: int = 192):
    """Returns f(queries, responses) -> mean per-token logprob of each
    response (np.ndarray), on the device of ``params``.  Each row is scored
    on its own tokens alone, so a batch split into chunks (``LOGIT_BYTES``)
    scores as the whole batch does."""
    cfg = model.cfg
    device = params["embed"].device
    rows_per_chunk = max(1, LOGIT_BYTES // (max_len * cfg.padded_vocab * 4))

    def _score(tokens, targets, mask):
        logits, _ = model.forward(params, {"tokens": tokens})
        logp = torch.log_softmax(logits[..., : cfg.vocab_size], dim=-1)
        ll = torch.gather(logp, -1, targets[..., None])[..., 0]
        return torch.sum(ll * mask, 1) / torch.clamp(torch.sum(mask, 1), min=1.0)

    def score(queries: List[str], responses: List[str]) -> np.ndarray:
        texts = [q + " . " + r for q, r in zip(queries, responses)]
        toks, mask = tokenizer.encode_batch(texts, max_len + 1)
        qlens = np.array([len(tokenizer.encode(q + " . ")) for q in queries])
        tgt_mask = mask[:, 1:].copy()
        for i, ql in enumerate(qlens):  # only score the response span
            tgt_mask[i, : max(ql - 1, 0)] = 0.0
        toks = torch.as_tensor(toks, dtype=torch.long).to(device)
        tgt_mask = torch.as_tensor(tgt_mask).to(device)
        out = []
        with torch.no_grad():
            for i in range(0, len(texts), rows_per_chunk):
                rows = slice(i, i + rows_per_chunk)
                out.append(_score(toks[rows, :-1], toks[rows, 1:], tgt_mask[rows]))
        return torch.cat(out).cpu().numpy()

    return score


# ---------------------------------------------------------------- features

_STRUCTURE_WORDS = ("first", "then", "summary", "steps", "common", "best",
                    "track", "consult")


def _words(t: str) -> set:
    return set(re.findall(r"[a-z']+", t.lower()))


def relevance_overlap(query: str, response: str) -> float:
    qw, rw = _words(query), _words(response)
    if not qw:
        return 0.0
    return len(qw & rw) / len(qw)


def structure_score(response: str) -> float:
    rw = _words(response)
    return sum(w in rw for w in _STRUCTURE_WORDS) / len(_STRUCTURE_WORDS)


def length_appropriateness(response: str, lo: int = 8, hi: int = 120) -> float:
    n = len(response.split())
    if n < lo:
        return n / lo
    if n > hi:
        return max(0.0, 1.0 - (n - hi) / hi)
    return 1.0


@dataclasses.dataclass(frozen=True)
class Persona:
    name: str
    w_loglik: float
    w_relevance: float
    w_structure: float
    w_length: float


PERSONAS = (
    Persona("factual_accuracy", 1.0, 0.3, 0.1, 0.0),
    Persona("user_experience", 0.4, 0.2, 0.4, 0.6),
    Persona("relevance_completeness", 0.4, 1.0, 0.2, 0.2),
)


def persona_score(persona: Persona, loglik: float, query: str,
                  response: str) -> float:
    return (persona.w_loglik * loglik
            + persona.w_relevance * relevance_overlap(query, response)
            + persona.w_structure * structure_score(response)
            + persona.w_length * length_appropriateness(response))
