"""GPTCache-style baseline, the paper's foil (§4.2.1, Fig. 2; counterpart of
``src/repro/core/baseline.py``).

A single-layer semantic cache: embed -> cosine top-k over the bank -> a
cross-encoder rereads the live candidates -> the best one's cached response
is returned VERBATIM when the top-1 similarity clears the threshold.  No
tweaking.  The lookup is the bank's flat scan (``kernels.cosine_topk``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.device import to_device
from repro_torch.models.embedder import encode as embed_encode
from repro_torch.models.reranker import score_pairs
from repro_torch.serving.batcher import pad_to_buckets
from repro_torch.tokenizer import HashWordTokenizer

from . import cache as cache_lib


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    similarity_threshold: float = 0.7
    rerank: str = "cross_encoder"  # cross_encoder | none
    topk: int = 4


class GPTCacheBaseline:
    """The bank lives on the embedder's device; ``_texts`` maps a slot to
    its (query, response) text."""

    def __init__(self, *, tokenizer: HashWordTokenizer, embedder_params, embedder_cfg,
                 reranker_params=None, reranker_cfg=None,
                 cache_cfg: cache_lib.CacheConfig, cfg: BaselineConfig,
                 max_query_len: int = 64):
        self.tok = tokenizer
        self.embedder_params = embedder_params
        self.embedder_cfg = embedder_cfg
        self.reranker_params = reranker_params
        self.reranker_cfg = reranker_cfg
        self.cache_cfg = cache_cfg
        self.cfg = cfg
        self.max_query_len = max_query_len
        self.device = embedder_params["embed"].device
        self.state = cache_lib.init_cache(cache_cfg, self.device)
        self._texts = {}

    def _dev(self, array):
        return to_device(array, self.device)

    def _embed_texts(self, texts: List[str]):
        toks, mask = self.tok.encode_batch(texts, self.max_query_len)
        toks, mask, b = pad_to_buckets(toks, mask)
        return embed_encode(self.embedder_params, self._dev(toks).long(), self._dev(mask),
                            self.embedder_cfg)[:b]

    def put(self, query: str, response: str):
        emb = self._embed_texts([query])[0]
        qt, qm = self.tok.encode_batch([query], self.cache_cfg.max_query_tokens)
        rt, rm = self.tok.encode_batch([response], self.cache_cfg.max_response_tokens)
        slot = int(cache_lib._victim_slot(self.state, self.cache_cfg))
        self.state = cache_lib.insert(self.state, self.cache_cfg, emb, self._dev(qt[0]),
                                      self._dev(qm[0]), self._dev(rt[0]), self._dev(rm[0]))
        self._texts[slot] = (query, response)

    def get(self, query: str) -> Tuple[Optional[str], Optional[str], float]:
        """Returns (cached_query, cached_response, score) or (None, None, s)."""
        scores, idxs = cache_lib.lookup(self.state, self.cache_cfg, self._embed_texts([query]))
        scores, idxs = scores[0].cpu().numpy(), idxs[0].cpu().numpy()
        live = [(s, i) for s, i in zip(scores, idxs) if i >= 0 and np.isfinite(s)]
        if not live or live[0][0] < self.cfg.similarity_threshold:
            return None, None, float(scores[0]) if np.isfinite(scores[0]) else -1.0
        if self.cfg.rerank == "cross_encoder" and self.reranker_params is not None:
            cands = [self._texts[int(i)][0] for _, i in live]
            ta, ma = self.tok.encode_batch([query] * len(cands), self.max_query_len)
            tb, mb = self.tok.encode_batch(cands, self.max_query_len)
            ta, ma, b = pad_to_buckets(ta, ma)
            tb, mb, _ = pad_to_buckets(tb, mb)
            rr = score_pairs(self.reranker_params, self._dev(ta).long(), self._dev(ma),
                             self._dev(tb).long(), self._dev(mb), self.reranker_cfg)
            best = int(np.argmax(rr[:b].cpu().numpy()))
        else:
            best = 0
        slot = int(live[best][1])
        cq, cr = self._texts[slot]
        return cq, cr, float(live[best][0])
