"""Request scheduler over ``TweakLLMEngine`` replicas (counterpart of
``src/repro/serving/scheduler.py``).

Requests are *submitted* individually with arrival timestamps, admitted
through a bounded queue (backpressure), coalesced into bucket-shaped serve
batches, deduplicated against identical in-flight queries, and dispatched
when a batch bucket fills or the oldest request's max-wait deadline
expires: queue -> coalesce -> dedup -> dispatch.

* **Dedup** — N concurrent copies of one query text join one group; a
  dispatch sends one copy, so N copies of the same MISS trigger ONE Big-LLM
  generation.  All N requests get the response; the N-1 extras count as
  ``joined``.
* **Determinism** — time enters only through the injected ``Clock``; the
  scheduler never sleeps and never reads wall time itself.  Under
  ``SimClock`` an arrival trace replays deterministically
  (``replay_trace``).
* **Backpressure** — ``submit`` raises ``QueueFull`` once
  ``queue_capacity`` requests are pending.
* **Service model** — optionally, a dispatch occupies the engine for
  ``service_model(batch_size)`` simulated seconds; ``poll`` does not
  dispatch again before ``busy_until``.
* **Continuous mode** (``SchedulerConfig(continuous=True)``) — ``slots``
  persistent decode slots replace the bucket barrier: a request dispatches
  the moment a slot frees and holds it for ``service_model(slots)/slots``
  seconds, the request-level mirror of ``serving/continuous.DecodeSession``.
  With a deterministic engine, responses and EngineStats equal barrier
  mode; only latency and throughput change.

``ReplicaScheduler`` serves N engine replicas through one submit surface:
least-loaded lanes, global dedup, work stealing, fleet-global backpressure
and stats; ``Scheduler`` is its one-lane case.  Pure host Python; it imports
nothing but the batcher.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, Iterable, List, Optional, Protocol, Tuple

from .batcher import bucket_batch


# ------------------------------------------------------------------ time
class Clock(Protocol):
    def now(self) -> float: ...


class WallClock:
    """Real time, for interactive / production use."""

    def now(self) -> float:
        return time.monotonic()


class SimClock:
    """Deterministic, manually-advanced clock — the simulation substrate.

    Never goes backwards; tests and benches own time entirely, so traces
    replay bit-identically with zero sleeps.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)  # hostsync: ok host wall-clock, never a device value

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance by negative dt={dt}")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        self._t = max(self._t, float(t))  # hostsync: ok host wall-clock, never a device value
        return self._t


class QueueFull(RuntimeError):
    """Admission rejected: the bounded request queue is at capacity."""


# ------------------------------------------------------------- requests
@dataclasses.dataclass
class SchedulerConfig:
    max_wait: float = 0.05        # flush deadline for the oldest request (s)
    max_batch: int = 32           # unique queries per dispatch (snaps UP to
                                  # a BATCH_BUCKETS shape so full dispatches
                                  # hit an existing engine compile bucket)
    queue_capacity: int = 1024    # bounded admission queue (backpressure)
    dedup: bool = True            # coalesce identical in-flight texts
    max_new_tokens: int = 32
    # Continuous (slot-based) mode, DESIGN.md §11: instead of holding a
    # bucket open behind the max_wait barrier, a request is dispatched
    # the moment a decode slot frees — the request-level mirror of
    # ``DecodeSession``'s mid-flight join/leave.  ``slots`` is the
    # persistent batch width; each admitted request occupies one slot
    # for ``service_model(slots) / slots`` simulated seconds (its
    # steady-state share of a full fused-decode step), so the service
    # process matches the device reality: rows at different depths
    # decode together and one finishing does not stall the rest.
    continuous: bool = False
    slots: int = 8
    # ReplicaScheduler only: let an idle replica steal queued groups from a
    # backed-up one.  A single-lane Scheduler has no one to steal from.
    steal: bool = True
    # Default per-request routing operating point (DESIGN.md §13); None
    # defers to the engine's RouterConfig.default_cost.  A request-level
    # ``submit(text, cost_threshold=...)`` overrides this.
    cost_threshold: Optional[float] = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if self.max_wait < 0:
            raise ValueError("max_wait must be >= 0")
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        self.max_batch = bucket_batch(self.max_batch)


@dataclasses.dataclass
class Request:
    """One submitted query; filled in when its dispatch completes."""
    rid: int
    text: str
    arrival: float
    # routing operating point for this request (None = engine default);
    # part of the dedup key — two copies of one text at different
    # operating points may route differently, so they must not coalesce
    cost_threshold: Optional[float] = None
    response: Optional[str] = None
    meta: Optional[dict] = None
    joined: bool = False          # rode along on another request's dispatch
    finish: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.response is not None

    @property
    def latency(self) -> Optional[float]:
        return None if self.finish is None else self.finish - self.arrival


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0
    completed: int = 0
    rejected: int = 0             # QueueFull admissions
    joined: int = 0               # dedup-coalesced copies (N-1 per group)
    batches: int = 0              # engine dispatches
    dispatched: int = 0           # unique queries sent to the engine
    stolen: int = 0               # groups moved between replica lanes
    big_tokens: int = 0
    small_tokens: int = 0
    busy_time: float = 0.0        # modeled engine-busy simulated seconds
    latency_sum: float = 0.0
    latency_max: float = 0.0

    @property
    def mean_latency(self) -> float:
        return self.latency_sum / max(self.completed, 1)

    @property
    def mean_batch(self) -> float:
        return self.dispatched / max(self.batches, 1)


# ------------------------------------------------------------ scheduler
@dataclasses.dataclass
class _Lane:
    """One replica's dispatch state: its FIFO of dedup groups, its
    barrier-mode busy horizon and its continuous-mode per-slot horizons
    (each replica owns one ``DecodeSession``'s worth of decode slots)."""
    engine: object
    groups: List[List[Request]] = dataclasses.field(default_factory=list)
    busy_until: float = 0.0
    slot_free: List[float] = dataclasses.field(default_factory=list)
    dispatched: int = 0
    batches: int = 0
    stolen_in: int = 0


class ReplicaScheduler:
    """Replica-aware frontend: N engines behind one submit surface.

    Drive it with ``submit`` + ``poll``; ``poll`` dispatches every batch
    whose flush condition holds at ``clock.now()`` and returns the requests
    completed so far.  ``next_wakeup`` tells a simulation loop the earliest
    time ``poll`` would act, so traces replay event-to-event with no busy
    waiting (``replay_trace``).  Across the lanes:

    * **Least-loaded dispatch** — a new group lands on the lane with the
      shortest queue, ties to the earlier free horizon, then the lower lane.
    * **Global dedup** — the dedup map spans lanes: N concurrent copies of
      one text join one group on ONE lane, so the fleet runs one generation
      per unique in-flight query.
    * **Work stealing** (``cfg.steal``) — at each poll, a lane that is idle
      with an empty queue takes the newest half of the backlog a busy lane
      cannot dispatch now.

    Backpressure (``queue_capacity``) and ``stats`` are fleet-global;
    per-lane counters live on ``lanes[i]``.
    """

    def __init__(self, engines, cfg: Optional[SchedulerConfig] = None, *,
                 clock: Optional[Clock] = None,
                 service_model: Optional[Callable[[int], float]] = None):
        if not engines:
            raise ValueError("ReplicaScheduler needs at least one engine")
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        self.clock = clock if clock is not None else WallClock()
        self.service_model = service_model
        self.stats = SchedulerStats()
        self.lanes = [_Lane(engine=e, slot_free=[0.0] * self.cfg.slots) for e in engines]
        # group of each in-flight (text, operating point); groups are ordered
        # by arrival (index 0 = primary, the rest join its dispatch)
        self._by_text: Dict[Tuple[str, Optional[float]], List[Request]] = {}
        # completions park here until a poll/flush RETURNS them: if one
        # dispatch in a multi-batch poll raises, earlier batches' completed
        # requests survive and are delivered by the next call
        self._completed: List[Request] = []
        self._n_pending = 0
        self._rid = itertools.count()

    @property
    def engines(self) -> List[object]:
        return [lane.engine for lane in self.lanes]

    # -------------------------------------------------------- admission
    @property
    def pending(self) -> int:
        return self._n_pending

    def _free_at(self, lane: _Lane) -> float:
        return min(lane.slot_free) if self.cfg.continuous else lane.busy_until

    def submit(self, text: str, cost_threshold: Optional[float] = None) -> Request:
        """Admit one request at ``clock.now()``; raises QueueFull.

        ``cost_threshold`` picks this request's routing operating point;
        None falls back to ``cfg.cost_threshold``, then to the engine's
        default.
        """
        if self._n_pending >= self.cfg.queue_capacity:
            self.stats.rejected += 1
            raise QueueFull(f"request queue at capacity ({self.cfg.queue_capacity})")
        if cost_threshold is None:
            cost_threshold = self.cfg.cost_threshold
        req = Request(next(self._rid), text, self.clock.now(), cost_threshold=cost_threshold)
        self.stats.submitted += 1
        key = (text, cost_threshold)
        group = self._by_text.get(key) if self.cfg.dedup else None
        if group is not None:
            group.append(req)           # joins its group's lane, wherever
        else:
            group = [req]
            lane = min(self.lanes, key=lambda ln: (len(ln.groups), self._free_at(ln)))
            lane.groups.append(group)
            if self.cfg.dedup:
                self._by_text[key] = group
        self._n_pending += 1
        return req

    # --------------------------------------------------------- dispatch
    def _lane_wakeup(self, lane: _Lane) -> Optional[float]:
        if not lane.groups:
            return None
        t = lane.groups[0][0].arrival
        if self.cfg.continuous:
            # no fill barrier: dispatch the moment a slot frees
            return max(t, min(lane.slot_free))
        if len(lane.groups) < self.cfg.max_batch:
            t += self.cfg.max_wait          # waiting to fill the bucket
        return max(t, lane.busy_until)

    def next_wakeup(self) -> Optional[float]:
        """Earliest time any lane would dispatch; None when all are idle."""
        wakeups = [w for w in map(self._lane_wakeup, self.lanes) if w is not None]
        return min(wakeups) if wakeups else None

    def _steal(self, now: float) -> None:
        """Idle lanes with empty queues take backlog busy lanes cannot serve.

        A donor's surplus is what its queue holds beyond what it can
        dispatch at ``now`` (nothing while busy; one batch, or its free
        slots, when free).  The thief takes the newest ceil(surplus/2)
        groups; the donor keeps its oldest, deadline-closest work.
        """
        if not self.cfg.steal or len(self.lanes) < 2:
            return
        for thief in self.lanes:
            if thief.groups or self._free_at(thief) > now:
                continue
            donor = max(self.lanes, key=lambda ln: len(ln.groups))
            if donor is thief:
                continue
            surplus = len(donor.groups)
            if self._free_at(donor) <= now:
                if self.cfg.continuous:
                    cap = sum(t <= now for t in donor.slot_free)
                else:
                    cap = self.cfg.max_batch
                surplus -= min(cap, self.cfg.max_batch)
            if surplus <= 0:
                continue
            take = surplus - surplus // 2
            moved = donor.groups[-take:]
            del donor.groups[-take:]
            # dedup entries follow their group objects; only the lane moves
            thief.groups.extend(moved)
            thief.stolen_in += len(moved)
            self.stats.stolen += len(moved)

    def poll(self) -> List[Request]:
        """Dispatch every due lane at ``clock.now()``, earliest wakeup first;
        returns the completions parked so far."""
        while True:
            now = self.clock.now()
            self._steal(now)
            due = [(w, i) for i, lane in enumerate(self.lanes)
                   if (w := self._lane_wakeup(lane)) is not None and w <= now]
            if not due:
                out, self._completed = self._completed, []
                return out
            self._dispatch(self.lanes[min(due)[1]])

    def flush(self) -> List[Request]:
        """Drain every lane now, ignoring deadlines (end of stream)."""
        while any(lane.groups for lane in self.lanes):
            for lane in self.lanes:
                if lane.groups:
                    self._dispatch(lane)
        out, self._completed = self._completed, []
        return out

    def _dispatch(self, lane: _Lane) -> None:
        if self.cfg.continuous:
            # the cohort is whatever fits the slots free RIGHT NOW, the
            # request-level analogue of DecodeSession.admit; each request
            # holds one slot for its share of a full-slot decode
            start = max(self.clock.now(), min(lane.slot_free))
            free = [i for i, t in enumerate(lane.slot_free) if t <= start]
            take = min(len(lane.groups), len(free), self.cfg.max_batch)
            groups = lane.groups[:take]
            result = self._serve(lane, groups)
            service = (self.service_model(self.cfg.slots) / self.cfg.slots
                       if self.service_model else 0.0)
            finish = start + service
            for i in free[:take]:
                lane.slot_free[i] = finish
            self.stats.busy_time += service * take
        else:
            take = min(len(lane.groups), self.cfg.max_batch)
            groups = lane.groups[:take]
            result = self._serve(lane, groups)
            start = max(self.clock.now(), lane.busy_until)
            service = self.service_model(take) if self.service_model else 0.0
            finish = start + service
            lane.busy_until = finish
            self.stats.busy_time += service
        lane.dispatched += len(groups)
        lane.batches += 1
        self._complete(groups, result, finish)

    def _serve(self, lane: _Lane, groups):
        # engine first, queue mutation after: if the engine raises, every
        # request stays pending (and countable) for a retry or flush
        texts = [g[0].text for g in groups]
        costs = [g[0].cost_threshold for g in groups]
        # only surface the kwarg when an operating point was actually set:
        # cost-oblivious engines (baselines, test doubles) keep working
        kw = ({"cost_thresholds": costs}
              if any(c is not None for c in costs) else {})
        result = lane.engine.handle_batch_result(
            texts, max_new_tokens=self.cfg.max_new_tokens, **kw)
        del lane.groups[:len(groups)]
        if self.cfg.dedup:
            for g in groups:
                self._by_text.pop((g[0].text, g[0].cost_threshold), None)
        return result

    def _complete(self, groups, result, finish: float) -> None:
        self.stats.batches += 1
        self.stats.dispatched += len(groups)
        self.stats.big_tokens += result.big_tokens
        self.stats.small_tokens += result.small_tokens
        for group, resp, meta in zip(groups, result.responses, result.meta):
            for j, req in enumerate(group):
                req.response = resp
                req.meta = dict(meta)
                req.joined = j > 0
                req.finish = finish
                self.stats.completed += 1
                self.stats.joined += int(j > 0)
                lat = finish - req.arrival
                self.stats.latency_sum += lat
                self.stats.latency_max = max(self.stats.latency_max, lat)
                self._completed.append(req)
        self._n_pending -= sum(len(g) for g in groups)


class Scheduler(ReplicaScheduler):
    """Event-driven continuous-batching frontend over one engine: a single
    lane, so stealing never applies."""

    def __init__(self, engine, cfg: Optional[SchedulerConfig] = None, *,
                 clock: Optional[Clock] = None,
                 service_model: Optional[Callable[[int], float]] = None):
        super().__init__([engine], cfg, clock=clock, service_model=service_model)

    @property
    def engine(self):
        return self.lanes[0].engine


# ------------------------------------------------------------- replay
def replay_trace(sched: ReplicaScheduler, trace: Iterable[Tuple[float, str]], *,
                 drain: bool = True) -> List[Request]:
    """Replay (arrival_time, text) events through a SimClock'd scheduler.

    Advances the scheduler's clock event-to-event (deadline fires between
    arrivals are honored in order), submits each arrival, and finally
    drains the queue.  Rejected (QueueFull) arrivals are shed and counted
    in ``sched.stats.rejected``.  Returns completed requests; sort by
    ``rid`` to recover submission order.
    """
    clock = sched.clock
    if not isinstance(clock, SimClock):
        raise TypeError("replay_trace requires a Scheduler on a SimClock")
    done: List[Request] = []
    for t, text in trace:
        while True:
            w = sched.next_wakeup()
            if w is None or w > t:
                break
            clock.advance_to(w)
            done.extend(sched.poll())
        clock.advance_to(t)
        try:
            sched.submit(text)
        except QueueFull:
            continue
        done.extend(sched.poll())
    while drain:
        w = sched.next_wakeup()
        if w is None:
            break
        clock.advance_to(w)
        done.extend(sched.poll())
    return done


def poisson_trace(texts: List[str], rate: float, *,
                  seed: int = 0) -> List[Tuple[float, str]]:
    """Poisson-process arrival trace over ``texts`` at ``rate`` req/s."""
    import numpy as np
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=len(texts)).tolist()  # hostsync: ok host numpy trace
    t, out = 0.0, []
    for g, text in zip(gaps, texts):
        t += g
        out.append((t, text))
    return out
