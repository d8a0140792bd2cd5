"""``Model`` facade over the ported stacks (counterpart of
``src/repro/models/model.py``): decoder-only stacks of attention, MoE and
recurrent blocks, with or without a prefix-embedding frontend
(``models.transformer``), and the encoder-decoder (``models.encdec``,
``is_encdec``); ``forward`` and ``loss`` for training, ``prefill`` and the
decode steps for serving.  A batch holds ``tokens`` (and ``targets``,
``mask`` for the loss), plus ``frames`` (B,F,d) for an encoder-decoder or,
optionally, ``prefix_embeds`` (B,P,frontend_dim) for a frontend config.

The capability flags read the block kinds of ``pattern`` and its remainder,
as the reference's do: a recurrent state (Mamba-2, RG-LRU) cannot be built
from a stored prefix, paged or rewound, and a windowed ring cannot be paged
or rewound, so those stacks report False for all three and their callers
use the full prefill and the dense decode step.  An encoder-decoder reports
False for all three (its cross caches are neither paged nor rewound), and a
frontend config has no prefix path but pages and verifies as its stack does.

Prefix-prefill contract (DESIGN.md §9): ``prefill_prefix`` returns the KV
state of a shared prompt prefix and ``prefill_with_prefix`` prefills only
the suffix while attending over it; the result matches ``prefill`` of the
concatenation.  Within the port on the CPU the match is held by the tests
(``tests/test_torch_model.py``); on the card cuBLAS may reduce the prefix's
K/V projection in another order at another row count, so it is held to
the generated tokens.  Only the fixed-block ``xla_flash`` attention
qualifies, as in the reference.  A MOE stack takes the path too, but there
the suffix's tokens form their own dispatch groups, so its MoE outputs
(and the K/V of later layers) can differ from the full prefill's where
capacity drops a pair: the reference's semantics.
"""
from __future__ import annotations

import dataclasses

from . import encdec as encdec_lib
from . import transformer as tf_lib
from .config import ATTN, MOE, ModelConfig


def _kv_stack(cfg: ModelConfig) -> bool:
    """Every layer a global-attention KV layer (ATTN or MOE, no window)."""
    kinds = set(cfg.block_pattern) | set(cfg.pattern_remainder)
    return cfg.sliding_window == 0 and kinds <= {ATTN, MOE}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def is_encdec(self) -> bool:
        return self.cfg.enc_layers > 0

    def init(self, generator, device):
        if self.is_encdec:
            return encdec_lib.init_encdec(self.cfg, generator, device)
        return tf_lib.init_lm(self.cfg, generator, device)

    # --- training -----------------------------------------------------
    def loss(self, params, batch):
        """batch keys: tokens, targets, mask [+ frames | prefix_embeds].
        Returns (loss, {"ce", "aux"[, "tokens"]})."""
        cfg = self.cfg
        if self.is_encdec:
            logits, aux = encdec_lib.forward(params, batch["frames"], batch["tokens"], cfg)
            ce = tf_lib.cross_entropy(logits, batch["targets"], batch["mask"], cfg.vocab_size)
            return ce + aux, {"ce": ce, "aux": aux}
        return tf_lib.loss_fn(params, batch["tokens"], batch["targets"], batch["mask"], cfg,
                              prefix_embeds=batch.get("prefix_embeds"))

    def unread_params(self, params, batch) -> list:
        """The leaves ``loss`` does not read on ``batch``: ``frontend_proj``
        when the batch carries no ``prefix_embeds``.  Every other leaf
        reaches the loss."""
        if "frontend_proj" in params and "prefix_embeds" not in batch:
            return [params["frontend_proj"]]
        return []

    def forward(self, params, batch):
        """(fp32 logits (B,S,V_padded), aux) of ``batch["tokens"]`` (after the
        prefix's P positions when ``batch`` holds ``prefix_embeds``)."""
        if self.is_encdec:
            return encdec_lib.forward(params, batch["frames"], batch["tokens"], self.cfg)
        return tf_lib.forward(params, batch["tokens"], self.cfg,
                              prefix_embeds=batch.get("prefix_embeds"))

    # --- inference ----------------------------------------------------

    def prefill(self, params, batch, capacity: int):
        if self.is_encdec:
            return encdec_lib.prefill(params, batch["frames"], batch["tokens"], self.cfg,
                                      capacity)
        return tf_lib.prefill(params, batch["tokens"], self.cfg, capacity,
                              prefix_embeds=batch.get("prefix_embeds"))

    @property
    def supports_prefix_prefill(self) -> bool:
        cfg = self.cfg
        return (not self.is_encdec and _kv_stack(cfg) and cfg.num_prefix_tokens == 0
                and cfg.attention_impl == "xla_flash")

    def _require_prefix(self):
        if not self.supports_prefix_prefill:
            raise NotImplementedError(
                f"{self.cfg.name}: prefix-cached prefill unsupported for this "
                f"architecture — use the full prefill")

    def prefill_prefix(self, params, tokens):
        """KV state of a shared prefix: tokens (B,P) -> caches (capacity P)."""
        self._require_prefix()
        _, caches = tf_lib.prefill(params, tokens, self.cfg, capacity=int(tokens.shape[1]))
        return caches

    def prefill_with_prefix(self, params, batch, capacity: int, prefix):
        """Suffix-only prefill over a stored prefix KV."""
        self._require_prefix()
        return tf_lib.prefill(params, batch["tokens"], self.cfg, capacity, prefix=prefix)

    def init_caches(self, batch_size: int, capacity: int, device):
        if self.is_encdec:
            return encdec_lib.init_decode_caches(batch_size, capacity, self.cfg, device)
        return tf_lib.init_caches(batch_size, capacity, self.cfg, device)

    def decode_step(self, params, token, caches):
        if self.is_encdec:
            return encdec_lib.decode_step(params, token, caches, self.cfg)
        return tf_lib.decode_step(params, token, caches, self.cfg)

    @property
    def supports_paged_decode(self) -> bool:
        """Decode over a paged KV pool: every cached layer a plain global KV
        cache, ATTN or MOE (a windowed ring buffer cannot be paged), and no
        encoder (its cross caches are not paged)."""
        return not self.is_encdec and _kv_stack(self.cfg)

    @property
    def supports_spec_decode(self) -> bool:
        """Verify (B, k) draft blocks and rewind the rejected suffix: the
        same structural condition as paged decode."""
        return self.supports_paged_decode

    def decode_block(self, params, tokens, caches):
        """tokens (B, k) -> (logits (B, k, V), caches); speculative verify.
        Caches carry per-row positions; the caller owns acceptance and the
        rewind of rejected tokens."""
        if not self.supports_spec_decode:
            raise NotImplementedError(
                f"{self.cfg.name}: block (speculative) decode unsupported for this "
                f"architecture — use decode_step")
        return tf_lib.decode_block(params, tokens, caches, self.cfg)


def build_model(cfg: ModelConfig) -> Model:
    if not cfg.enc_layers:
        tf_lib.check_supported(cfg)
    return Model(cfg=cfg)
