"""Contrastive training of the sentence embedder (counterpart of
``src/repro/training/embedder_train.py``).

Bidirectional InfoNCE over generated paraphrase pairs (duplicates are the
positives, the other rows of the batch the negatives) plus a margin push on
each anchor's hard negative (a polarity flip or an entity swap).  Batches
are ``QuestionPairGenerator(seed).triple()`` rows through
``HashWordTokenizer.encode_batch``: the reference's batches, drawn from the
port's copies of both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.data.questions import QuestionPairGenerator
from repro_torch.device import to_device
from repro_torch.models.embedder import encode as embed_encode
from repro_torch.tokenizer import HashWordTokenizer

from .optimizer import AdamWConfig, init_opt_state, train_loop


def info_nce_loss(params, cfg, ta, ma, tb, mb, tn, mn, temp: float = 0.07,
                  neg_margin: float = 0.4):
    """0.5 * (InfoNCE a->b + b->a) at ``temp`` + mean relu(cos(a, n) - (1 -
    neg_margin)) over the hard negatives."""
    za = embed_encode(params, ta, ma, cfg)
    zb = embed_encode(params, tb, mb, cfg)
    logits = za @ zb.T / temp
    labels = torch.arange(za.shape[0], device=za.device)
    lab = F.cross_entropy(logits, labels)
    lba = F.cross_entropy(logits.T, labels)
    zn = embed_encode(params, tn, mn, cfg)
    neg_sim = torch.sum(za * zn, dim=-1)
    hard = torch.mean(F.relu(neg_sim - (1.0 - neg_margin)))
    return 0.5 * (lab + lba) + hard


def triple_batch(gen: QuestionPairGenerator, tokenizer: HashWordTokenizer, batch: int,
                 max_len: int, device):
    """One batch of ``batch`` triples: (ta, ma, tb, mb, tn, mn) on ``device``
    (tokens int64, masks float32)."""
    triples = [gen.triple() for _ in range(batch)]
    out = []
    for j in range(3):
        t, m = tokenizer.encode_batch([tr[j].text for tr in triples], max_len)
        out += [to_device(t, device).long(), to_device(m, device)]
    return tuple(out)


def train_embedder(params, cfg, tokenizer: HashWordTokenizer, *, steps: int = 200,
                   batch: int = 32, max_len: int = 32, lr: float = 1e-3, seed: int = 0):
    """Train ``params`` in place; returns ``(params, losses)``."""
    gen = QuestionPairGenerator(seed=seed)
    device = params["embed"].device
    batches = (triple_batch(gen, tokenizer, batch, max_len, device) for _ in range(steps))
    losses = train_loop(params, init_opt_state(params), AdamWConfig(lr=lr, weight_decay=0.0),
                        info_nce_loss, cfg, batches)
    return params, losses
