"""Threshold routing (counterpart of ``src/repro/core/router.py``).

The single-stage router of the paper (§3.1) with the JAX package's
calibrated operating curve: a per-request cost in [0, 1] picks the
TWEAK/MISS boundary ``tau`` (``threshold_for``), and ``route_cascade``
thresholds the top-1 similarity at it.  At ``cost == default_cost`` tau is
``tweak_threshold`` exactly, so ``route`` is that operating point.

With ``band > 0`` the router is a two-stage cascade: rows whose top-1 lies
within ``band/2`` of tau come back ``UNCERTAIN`` from stage 1, and stage 2
(``stage2_combine``, run by ``cache.make_second_stage`` only on batches that
hold such rows) blends multi-probe agreement over the top-k with the
cross-encoder reranker's evidence to commit TWEAK or MISS, and may re-select
the serving candidate.

Admission control (IVF caches): a per-cluster hit EMA; a cluster that keeps
missing stops admitting inserts (``admit_floor`` 0 admits everything).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MISS, TWEAK, EXACT = 0, 1, 2
UNCERTAIN = 3          # provisional stage-1 decision; never leaves the bank


def where_int(cond, a: int, b: int):
    """``torch.where(cond, a, b)`` of two Python ints, in int32 (torch would
    make it int64)."""
    return torch.full(cond.shape, b, dtype=torch.int32, device=cond.device).masked_fill_(cond, a)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    tweak_threshold: float = 0.7   # paper Table 1 initial threshold
    exact_threshold: float = 0.9999
    default_cost: float = 0.5
    cal_costs: tuple = ()
    cal_taus: tuple = ()
    cal_span: float = 0.2
    # stage-2 cascade: width of the |top1 - tau| window (0 = single stage)
    band: float = 0.0
    probe_temp: float = 0.05       # sharpness of the multi-probe agreement
    w_agree: float = 0.4           # weight of top-k agreement in stage 2
    w_rerank: float = 0.6          # weight of the cross-encoder evidence
    commit_at: float = 0.5         # normalized confidence needed for TWEAK
    # per-cluster admission control (IVF caches; floor 0 disables)
    admit_alpha: float = 0.05      # hit-EMA step per observation
    admit_floor: float = 0.0       # suppress inserts when the cluster EMA < floor
    admit_min: int = 16            # observations before a cluster can be shut

    def __post_init__(self):
        if len(self.cal_costs) != len(self.cal_taus):
            raise ValueError(
                f"calibration knots disagree: {len(self.cal_costs)} costs "
                f"vs {len(self.cal_taus)} taus")
        if self.cal_costs and len(self.cal_costs) < 2:
            raise ValueError("calibration needs >= 2 knots")
        if not 0.0 <= self.default_cost <= 1.0:
            raise ValueError(f"default_cost {self.default_cost} not in [0,1]")


def calibration(cfg: RouterConfig):
    """The (cal_costs, cal_taus) knots as python floats, derived when not given."""
    if cfg.cal_costs:
        return tuple(cfg.cal_costs), tuple(cfg.cal_taus)
    t = float(cfg.tweak_threshold)  # hostsync: ok host config float
    dc = min(max(float(cfg.default_cost), 1e-3), 1.0 - 1e-3)  # hostsync: ok host config float
    return (0.0, dc, 1.0), (t - cfg.cal_span, t, 1.0)


def _interp(x, xs, ys):
    """``jnp.interp`` (same formula, so the same float32 result)."""
    # knots go up without waiting for the stream (a blocking copy would sync)
    xs_t = torch.tensor(xs, dtype=torch.float32).to(x.device, non_blocking=True)
    ys_t = torch.tensor(ys, dtype=torch.float32).to(x.device, non_blocking=True)
    i = torch.clamp(torch.searchsorted(xs_t, x, right=True), 1, len(xs) - 1)
    df = ys_t[i] - ys_t[i - 1]
    dx = xs_t[i] - xs_t[i - 1]
    delta = x - xs_t[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))  # hostsync: ok numpy constant
    f = torch.where(dx0, ys_t[i - 1], ys_t[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xs_t[0], ys_t[0], f)
    return torch.where(x > xs_t[-1], ys_t[-1], f)


def threshold_for(cost, cfg: RouterConfig):
    """Per-request TWEAK/MISS boundary tau (B,) float32 from costs (B,)."""
    cost = cost.to(torch.float32)
    xs, ys = calibration(cfg)
    tau = _interp(cost, xs, ys)
    if not cfg.cal_costs:
        tau = torch.where(cost == cfg.default_cost, cfg.tweak_threshold, tau)
    return tau


def route(scores, cfg: RouterConfig):
    """scores (B,) top-1 cosine similarity -> decisions (B,) int32."""
    d = where_int(scores >= cfg.tweak_threshold, TWEAK, MISS)
    return torch.where(scores >= cfg.exact_threshold, EXACT, d)


def route_cascade(top1, tau, cfg: RouterConfig):
    """Stage-1 decisions at per-row operating points ``tau``.  EXACT keeps
    precedence; with ``band > 0`` the other rows within ``band/2`` of tau
    are UNCERTAIN."""
    d = where_int(top1 >= tau, TWEAK, MISS)
    d = torch.where(top1 >= cfg.exact_threshold, EXACT, d)
    if cfg.band > 0.0:
        unc = ((top1 - tau).abs() < 0.5 * cfg.band) & (top1 < cfg.exact_threshold)
        d = torch.where(unc, UNCERTAIN, d)
    return d.to(torch.int32)


def stage2_combine(scores, rerank_logits, live, tau, cfg: RouterConfig):
    """Stage-2 evidence over the (B,K) shortlist: cosine ``scores``, the
    reranker's ``rerank_logits`` on the same candidates, ``live`` the valid
    candidates, ``tau`` (B,) the operating points.

    conf = w_agree * (mean over live candidates of sigmoid((s - tau) /
    probe_temp)) + w_rerank * sigmoid(max live logit); a row commits when
    conf >= commit_at * (w_agree + w_rerank).  ``best`` is the live
    candidate of largest blended evidence w_agree * sigmoid((s - tau) /
    probe_temp) + w_rerank * sigmoid(logit), which may not be position 0.
    A row with no live candidate has conf 0, best 0 and never commits.
    Returns ``(commit (B,) bool, best (B,) int32, conf (B,) float32)``."""
    nlive = torch.clamp(live.sum(dim=1, dtype=torch.int32), min=1)
    probe = torch.sigmoid((scores - tau[:, None]) / cfg.probe_temp)
    agree = torch.where(live, probe, 0.0).sum(dim=1) / nlive
    rr = torch.where(live, rerank_logits, float("-inf"))
    evidence = torch.sigmoid(rr.amax(dim=1))
    conf = cfg.w_agree * agree + cfg.w_rerank * evidence
    commit = conf >= cfg.commit_at * (cfg.w_agree + cfg.w_rerank)
    cand = cfg.w_agree * probe + cfg.w_rerank * torch.sigmoid(rr)
    # all -inf gives index 0, as jnp.argmax does
    best = torch.argmax(torch.where(live, cand, float("-inf")), dim=1)
    return commit, best.to(torch.int32), conf.to(torch.float32)


def admission_admit(adm_ema, adm_count, cluster, cfg: RouterConfig):
    """Per-row admit flag from the cluster statistics before this batch.
    Rows with no cluster (-1) admit; a cluster shuts only after
    ``admit_min`` observations put its hit EMA below ``admit_floor``."""
    c = cluster.clamp(0, adm_ema.shape[0] - 1).long()
    shut = (adm_count[c] >= cfg.admit_min) & (adm_ema[c] < cfg.admit_floor)
    return (cluster < 0) | ~shut


def admission_update(adm_ema, adm_count, cluster, hit, obs, cfg: RouterConfig):
    """Batched EMA update of the per-cluster hit rate, independent of row
    order: a cluster with ``n_c`` observations in the batch takes the closed
    form of ``n_c`` EMA steps towards the batch's mean hit rate,

        ema_c <- (1-a)^n_c * ema_c + (1 - (1-a)^n_c) * hits_c / n_c.

    Rows with ``obs`` False or no cluster add to an extra slot that is
    dropped.  Returns (ema, count)."""
    n = adm_ema.shape[0]
    w = torch.where(obs & (cluster >= 0), cluster, n).long()
    z = torch.zeros(n + 1, dtype=torch.float32, device=adm_ema.device)
    n_c = z.index_add(0, w, torch.ones_like(w, dtype=torch.float32))[:n]
    h_c = z.index_add(0, w, hit.to(torch.float32))[:n]
    decay = torch.pow(1.0 - cfg.admit_alpha, n_c)
    mean = h_c / torch.clamp(n_c, min=1.0)
    ema = torch.where(n_c > 0, decay * adm_ema + (1.0 - decay) * mean, adm_ema)
    return ema, adm_count + n_c.to(adm_count.dtype)


def band_edges(cfg: RouterConfig = None):
    """Similarity-band edges for the active config (paper bands at 0.7)."""
    lo = 0.7 if cfg is None else float(cfg.tweak_threshold)  # hostsync: ok host config float
    width = max((1.0 - lo) / 3.0, 0.0)
    e = [round(lo + i * width, 9) for i in range(3)]
    return (*e, max(1.01, lo))


def bands_for(cfg: RouterConfig = None):
    e = band_edges(cfg)
    return tuple((e[i], e[i + 1]) for i in range(3))


def band_of(scores, cfg: RouterConfig = None):
    """Band index per query: -1 below the tweak threshold, else 0/1/2."""
    b = torch.full(scores.shape, -1, dtype=torch.int32, device=scores.device)
    for i, (lo, hi) in enumerate(bands_for(cfg)):
        b = torch.where((scores >= lo) & (scores < hi), i, b)
    return b
