"""Spans and counters of the serving path, kept in memory.

A :class:`SpanRecorder` holds one :class:`Span` a timed stage: its name,
start and end, the id of the span open around it (its parent), the id of
its dispatch, the language model that made it (``small``, ``big``, or None
outside a generate call), and a few integer counts that the span site
passes.  The scheduler opens a ``dispatch`` span around each engine call;
that span is its own dispatch, and every span opened inside it carries its
id.

The scheduler, the engine and each ``Generator`` hold a ``recorder``
attribute, None by default: a span site then costs one attribute test.
Setting the engine's hands the recorder to its small and big generators,
each through a view that tags its spans with the model; so the scheduler's
and the engine's attachments record the whole tree.  With a recorder, a
site passes only values already on the host (shapes, real prompt lengths,
the lengths that the decode block's one copy brought back), so recording
adds no host sync and no device read.

Every span is timed by the recorder's clock, ``time.monotonic()`` (the
clock of ``scheduler.WallClock``) unless it is given another: a scheduler
on a ``SimClock`` is given a recorder on that clock's ``now``, so that the
engine's spans nest in time inside its dispatches.  Nothing is written
out: the caller reads ``spans`` after the run.

Sites, with the counts they pass:

* ``serving/scheduler.py``: ``dispatch`` (rows);
* ``core/engine.py``: ``embed``, ``route``, ``stage2``, ``exact``,
  ``tweak_prompt`` (calls: the small LM's generate calls it set up),
  ``miss_prompt``, ``insert``, ``prefix_build``;
* ``serving/generate.py``: ``prefill`` (computed: rows × padded prompt
  length, needed: real prompt tokens, both without a reused prefix),
  ``decode`` (rows, steps, budget), ``fetch`` (tokens: real generated
  tokens).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

DISPATCH = "dispatch"


@dataclasses.dataclass
class Span:
    sid: int
    name: str
    start: float
    end: Optional[float] = None
    parent: Optional[int] = None
    dispatch: Optional[int] = None
    lm: Optional[str] = None
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start


class SpanRecorder:
    """The spans of one process, in the order they opened."""

    def __init__(self, now: Callable[[], float] = time.monotonic):
        self.now = now
        self.lm: Optional[str] = None
        self.spans: List[Span] = []
        self._open: List[Span] = []

    def tagged(self, lm: str) -> "SpanRecorder":
        """This recorder (its spans, open spans and clock shared), tagging
        the spans opened through it with ``lm``."""
        view = SpanRecorder(self.now)
        view.lm, view.spans, view._open = lm, self.spans, self._open
        return view

    def open(self, name: str) -> Span:
        """Start a span inside the innermost open one."""
        parent = self._open[-1] if self._open else None
        sid = len(self.spans)
        if name == DISPATCH:
            dispatch = sid
        else:
            dispatch = None if parent is None else parent.dispatch
        span = Span(sid, name, self.now(), parent=None if parent is None else parent.sid,
                    dispatch=dispatch, lm=self.lm)
        self.spans.append(span)
        self._open.append(span)
        return span

    def close(self, name: str, **counts) -> Span:
        """End the innermost open span called ``name``, with its counts
        (host integers).  Spans opened inside it and left open, by an
        exception between their sites, end with it."""
        t = self.now()
        while self._open:
            span = self._open.pop()
            span.end = t
            if span.name == name:
                span.counts.update({k: int(v) for k, v in counts.items()})
                return span
        raise ValueError(f"no open span {name!r}")
