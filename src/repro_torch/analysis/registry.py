"""The port's hot modules and hot paths (counterpart of
``src/repro/analysis/registry.py``, DESIGN.md §10).

``HOT_MODULES`` keeps the reference's list and layout, with paths relative
to ``src/repro_torch``: the host-sync lint rules (HS1xx) apply only inside
them, where a stray ``.item()`` or ``.cpu()`` is a per-request round trip
that defeats the O(1)-syncs-per-batch design (DESIGN.md §5).

The reference's second table, ``JIT_REGISTRY``, declares each ``jax.jit``
site's donation and static arguments.  Eager PyTorch has no jit sites, so
the port declares its **hot paths** instead (:class:`HotPath`): the
function, the host syncs one call may make, the arguments it must update in
place (the counterpart of ``donate_argnums``: the state tensors keep their
storage), and the arguments it must leave unwritten (the counterpart of
"read-only, no aliasing").  ``analysis/lint.py`` checks that every entry
names a function that exists (JR403's counterpart); ``analysis/contracts.py``
runs each entry and holds it to its declaration.

Conventions: ``file`` is relative to ``src/repro_torch`` (posix
separators); ``qualname`` is ``Class.method`` or ``function``; ``syncs`` is
the fixed part of the budget, and ``extra`` names what adds to it (the
contract computes the sum from the call it made).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# --------------------------------------------------------------- hot set
# Entries ending in "/" are directory prefixes.
HOT_MODULES: Tuple[str, ...] = (
    "core/cache.py",
    "core/router.py",
    "core/index.py",
    "core/engine.py",
    "core/distributed.py",
    "serving/generate.py",
    "serving/scheduler.py",
    "serving/paged_kv.py",
    "serving/continuous.py",
    "models/",
    "kernels/",
)


def is_hot(rel: str) -> bool:
    """Is ``rel`` (path relative to src/repro_torch) a hot module?"""
    rel = rel.replace("\\", "/")
    for m in HOT_MODULES:
        if m.endswith("/"):
            if rel.startswith(m):
                return True
        elif rel == m:
            return True
    return False


# ------------------------------------------------------------- hot paths

@dataclasses.dataclass(frozen=True)
class HotPath:
    """One hot path and its contract."""
    file: str                       # path relative to src/repro_torch
    qualname: str                   # "Class.method" or "function"
    syncs: int                      # host syncs a call makes, fixed part
    extra: str = ""                 # what adds syncs to a call, if anything
    writes: Tuple[str, ...] = ()    # arguments updated in place (storage kept)
    reads: Tuple[str, ...] = ()     # arguments left unwritten (version kept)
    note: str = ""                  # why: shown in contract failures

    def __post_init__(self):
        if not self.note:
            raise ValueError(f"{self.file}::{self.qualname}: a hot path needs a note")


HOT_PATHS: Tuple[HotPath, ...] = (
    # ---- the reference's five contracts -----------------------------
    HotPath("core/cache.py", "lookup_and_touch", 0, writes=("state",),
            note="fused lookup + route + touch: the hit accounting (hits, last_used, "
                 "clock) lands in the bank's own tensors, no host read (DESIGN.md §5)"),
    HotPath("core/cache.py", "insert_batch", 0, writes=("state",),
            note="miss-batch commit in place; count is a host int, the slots stay on "
                 "the device for the caller's one copy"),
    HotPath("core/cache.py", "lookup", 0, reads=("state",),
            note="IVF probe (index='ivf'): a fixed shortlist whatever the queries, "
                 "the bank read only (DESIGN.md §7)"),
    HotPath("serving/generate.py", "Generator._decode_fused", 0, writes=("caches",),
            note="the whole decode on the device: tokens, lengths and done flags stay "
                 "there; the caller makes the call's one copy (DESIGN.md §8)"),
    HotPath("serving/generate.py", "Generator.generate_with_lengths", 1,
            extra="spec_steps + 1 more with drafts (the speculative loop)",
            reads=("prefix_cache",),
            note="prefill (over a shared prefix KV left unwritten, DESIGN.md §9) and "
                 "the fused decode: one host copy of the (B, T) block per call, "
                 "whatever max_new_tokens is"),
    HotPath("serving/generate.py", "Generator.build_prefix_cache", 0,
            note="one prefill of the shared instruction prefix per batch bucket; "
                 "the ids are host ints"),
    # ---- the port's own budgeted sites -------------------------------
    HotPath("serving/generate.py", "Generator._decode_fused_spec", 2,
            extra="+1 a verify iteration (spec_steps); equals last_spec_syncs",
            writes=("caches",),
            note="draft-verify decode: eager PyTorch reads one flag pair per "
                 "iteration test where JAX's while_loop tests on the device, and "
                 "the final copy (ROADMAP North star)"),
    HotPath("core/engine.py", "TweakLLMEngine.handle_batch_result", 1,
            extra="+1 with UNCERTAIN rows (stage 2), +1 a Generator call (TWEAK, "
                  "MISS), +1 an insert_batch",
            note="the one per-batch route fetch (scores, slots, decisions, admit "
                 "flags in one copy); equals last_route_syncs plus the generator "
                 "and insert terms (DESIGN.md §5, §13)"),
    HotPath("core/engine.py", "TweakLLMEngine._insert_entries", 1,
            note="the one host copy of the committed slots per insert, for the "
                 "text and draft mirrors"),
    HotPath("training/trainer.py", "make_train_step", 0,
            writes=("params", "opt_state"),
            note="the step reads nothing back: the loss stays a 0-d tensor, the "
                 "parameters and AdamW moments are written in place"),
)


def path(file: str, qualname: str) -> HotPath:
    """The registered entry of ``file::qualname``."""
    for p in HOT_PATHS:
        if p.file == file and p.qualname == qualname:
            return p
    raise KeyError(f"{file}::{qualname} is not a registered hot path")
