"""What the harness sees of the program: thin wrappers around the engine's
entry, its bank and its two generators, which time each call on the host
clock (the spans ``dispatch``, ``lookup``, ``small_gen``, ``big_gen``,
``insert``) and keep what each returned, for the check after the window.

The wrappers hold references only: device results are cloned (no copy to
the host, so the window gains no host sync), host results are kept as the
program returned them.
"""
from __future__ import annotations

import time

class Log:
    def __init__(self):
        self.dispatches = []          # one dict per handle_batch_result call
        self.spans = []               # (name, start, end, dispatch index)
        self.current = None           # the dispatch being served
        self.inserted = 0             # rows committed to the bank so far (host count)

    def span(self, name, fn, *args, **kw):
        t0 = time.monotonic()
        try:
            return fn(*args, **kw)
        finally:
            t1 = time.monotonic()
            self.spans.append((name, t0, t1, None if self.current is None
                               else self.current["index"]))


class EngineEntry:
    """The engine as the scheduler sees it: ``handle_batch_result`` timed
    and kept, with the texts it was given."""

    def __init__(self, engine, log: Log):
        self.engine, self.log = engine, log

    def handle_batch_result(self, texts, **kw):
        d = {"index": len(self.log.dispatches), "texts": list(texts), "route": None,
             "small": [], "big": [], "inserts": []}
        self.log.dispatches.append(d)
        self.log.current = d
        try:
            res = self.log.span("dispatch", self.engine.handle_batch_result, texts, **kw)
        finally:
            self.log.current = None
        name, t0, t1, _ = self.log.spans[-1]
        d.update(start=t0, end=t1, result=res)
        return res


class BankProxy:
    """The engine's bank with ``route_batch`` and ``insert_batch`` timed;
    the query embeddings, scores, slots and decisions of each lookup and
    the slots of each insert kept (cloned on the device), with the rows the
    bank held at each lookup (counted on the host from the commits)."""

    def __init__(self, bank, log: Log):
        self.__dict__["_bank"] = bank
        self.__dict__["_log"] = log

    def __getattr__(self, name):
        return getattr(self._bank, name)

    def __setattr__(self, name, value):
        setattr(self._bank, name, value)

    def route_batch(self, q_embs, cost=None):
        out = self._log.span("lookup", self._bank.route_batch, q_embs, cost)
        d = self._log.current
        if d is not None:
            _, t0, t1, _ = self._log.spans[-1]
            d["route"] = {"q": q_embs.detach().clone(), "scores": out[0].clone(),
                          "idx": out[1].clone(), "dec": out[2].clone(), "start": t0,
                          "end": t1, "rows": int(q_embs.shape[0]),
                          "bank_rows": min(self._log.inserted, self._bank.cfg.capacity)}
        return out

    def insert_batch(self, embs, q_tokens, q_mask, r_tokens, r_mask, count):
        slots = self._log.span("insert", self._bank.insert_batch, embs, q_tokens, q_mask,
                               r_tokens, r_mask, count)
        self._log.inserted += int(count)
        if self._log.current is not None:
            self._log.current["inserts"].append({"count": int(count), "slots": slots.clone()})
        return slots


class GeneratorProxy:
    """A generator with ``generate_with_lengths`` timed and its inputs and
    outputs kept (host arrays, as the program returns them)."""

    def __init__(self, gen, log: Log, kind: str):
        self.__dict__["_gen"] = gen
        self.__dict__["_log"] = log
        self.__dict__["_kind"] = kind

    def __getattr__(self, name):
        return getattr(self._gen, name)

    def __setattr__(self, name, value):
        setattr(self._gen, name, value)

    def generate_with_lengths(self, batch, **kw):
        out = self._log.span(f"{self._kind}_gen", self._gen.generate_with_lengths, batch, **kw)
        pc = kw.get("prefix_cache")
        _, t0, t1, _ = self._log.spans[-1]
        rec = {"start": t0, "end": t1, "tokens": batch["tokens"],
               "prefix": list(pc.token_ids) if pc else [], "out": out[0], "lengths": out[1],
               "ended": out[2]}
        d = self._log.current
        if d is not None:
            d[self._kind].append(rec)
        return out


def attach(engine, log: Log) -> EngineEntry:
    """Wrap an engine's bank and generators in place; returns the entry the
    scheduler is given."""
    engine.bank = BankProxy(engine.bank, log)
    engine.small = GeneratorProxy(engine.small, log, "small")
    engine.big = GeneratorProxy(engine.big, log, "big")
    return EngineEntry(engine, log)
