"""``Model`` facade over the ported decoder-only stack (counterpart of
``src/repro/models/model.py``, decoder-only ATTN stacks only): ``forward``
and ``loss`` for training, ``prefill`` and the decode steps for serving.

Prefix-prefill contract (DESIGN.md §9): ``prefill_prefix`` returns the KV
state of a shared prompt prefix and ``prefill_with_prefix`` prefills only
the suffix while attending over it; the result matches ``prefill`` of the
concatenation.  Within the port on the CPU the match is held by the tests
(``tests/test_torch_model.py``); on the card cuBLAS may reduce the prefix's
K/V projection in another order at another row count, so it is held to
the generated tokens.  Only the fixed-block ``xla_flash`` attention
qualifies, as in the reference.
"""
from __future__ import annotations

import dataclasses

from . import transformer as tf_lib
from .config import ATTN, ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator, device):
        return tf_lib.init_lm(self.cfg, generator, device)

    # --- training -----------------------------------------------------
    def loss(self, params, batch):
        """batch keys: tokens, targets, mask.  Returns (loss, {"ce", "aux",
        "tokens"})."""
        return tf_lib.loss_fn(params, batch["tokens"], batch["targets"], batch["mask"],
                              self.cfg)

    def forward(self, params, batch):
        """(fp32 logits (B,S,V_padded), aux) of ``batch["tokens"]``."""
        return tf_lib.forward(params, batch["tokens"], self.cfg)

    # --- inference ----------------------------------------------------

    def prefill(self, params, batch, capacity: int):
        return tf_lib.prefill(params, batch["tokens"], self.cfg, capacity)

    @property
    def supports_prefix_prefill(self) -> bool:
        cfg = self.cfg
        return (cfg.enc_layers == 0 and cfg.sliding_window == 0
                and set(cfg.block_pattern) == {ATTN} and cfg.num_prefix_tokens == 0
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
        return tf_lib.init_caches(batch_size, capacity, self.cfg, device)

    def decode_step(self, params, token, caches):
        return tf_lib.decode_step(params, token, caches, self.cfg)

    @property
    def supports_paged_decode(self) -> bool:
        """Decode over a paged KV pool: every cached layer a plain global KV
        cache (a windowed ring buffer cannot be paged)."""
        return self.cfg.sliding_window == 0 and set(self.cfg.block_pattern) == {ATTN}

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
    tf_lib.check_supported(cfg)
    return Model(cfg=cfg)
