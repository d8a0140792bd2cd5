"""Supervised training of the cross-encoder reranker (counterpart of
``src/repro/training/reranker_train.py``).

Sigmoid BCE on the duplicate logit of generated pairs: duplicates are the
positives; hard negatives (polarity flips, entity swaps: the near misses
inside the cascade's uncertainty band) and random pairs the negatives.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.data.questions import QuestionPairGenerator
from repro_torch.device import to_device
from repro_torch.models.reranker import score_pairs
from repro_torch.tokenizer import HashWordTokenizer

from .optimizer import AdamWConfig, init_opt_state, train_loop


def pair_bce_loss(params, cfg, ta, ma, tb, mb, labels):
    """Mean sigmoid BCE of the logits of pairs (a, b) against labels (B,)
    in {0, 1}."""
    logits = score_pairs(params, ta, ma, tb, mb, cfg)
    return -torch.mean(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))


def pair_batch(gen: QuestionPairGenerator, tokenizer: HashWordTokenizer, batch: int,
               max_len: int, hard_frac: float, device):
    """One batch of ``gen.generate(batch, dup_frac=0.5, hard_frac)`` pairs:
    (ta, ma, tb, mb, labels) on ``device``."""
    pairs = gen.generate(batch, dup_frac=0.5, hard_frac=hard_frac)
    ta, ma = tokenizer.encode_batch([a.text for a, b, y in pairs], max_len)
    tb, mb = tokenizer.encode_batch([b.text for a, b, y in pairs], max_len)
    y = np.asarray([float(y) for a, b, y in pairs], np.float32)
    return (to_device(ta, device).long(), to_device(ma, device),
            to_device(tb, device).long(), to_device(mb, device), to_device(y, device))


def train_reranker(params, cfg, tokenizer: HashWordTokenizer, *, steps: int = 150,
                   batch: int = 32, max_len: int = 24, lr: float = 1e-3,
                   hard_frac: float = 0.5, seed: int = 0):
    """Train ``params`` in place; returns ``(params, losses)``."""
    gen = QuestionPairGenerator(seed=seed)
    device = params["embed"].device
    batches = (pair_batch(gen, tokenizer, batch, max_len, hard_frac, device) for _ in range(steps))
    losses = train_loop(params, init_opt_state(params), AdamWConfig(lr=lr, weight_decay=0.0),
                        pair_bce_loss, cfg, batches)
    return params, losses
