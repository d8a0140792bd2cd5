"""The comparison that decides ``correct``: what the timed path produced,
held to the plain reference (``reference.py``) once the window has closed.

Every window dispatch (all its rows):
  * ``embed_err``  the largest |program - reference| of a query embedding,
    and of the embedding row an insert wrote to the bank;
  * ``score_err``  |the program's top-1 score - the reference's cosine of the
    same query and bank row|, the bank being the reference's own embeddings
    of every entry inserted so far (the warm set, then each MISS in order);
  * ``top1_err``   |the program's top-1 score - the reference's best cosine
    over the bank rows valid at that dispatch|: a wrong pick or a wrong score;
  * ``mismatch``   a count, limit 0: routes other than the reference's (away
    from a threshold by more than ROUTE_EPS), slots an insert took other than
    the FIFO's next ones, EXACT answers other than the cached response.

Sampled dispatches (``sample``; the one that served the most tokens among
them) also:
  * every MISS and TWEAK prompt the program fed its generators against the
    reference's own build of it from the request texts and the cached pair
    (``prompts.py``), each answer against the tokens it was generated as,
    each row an insert wrote (tokens) against the reference's: ``mismatch``;
  * ``big_gap`` / ``small_gap``: the widest gap by which a served token's
    logit lies below the reference's best at that position, the reference
    run teacher-forced over the prompt and the tokens the program decoded;
    ``big_gap_mean`` / ``small_gap_mean`` the mean gap over those tokens (on
    a MoE model the widest gap is set by a routing near-tie at one token,
    which rounding of any precision flips, and does not separate the
    program from the control; the mean does).

A cell's limits file names the numbers it compares; the others are
printed with no limit.

The control (``control=True``) puts the reference in the program's place
at the next precision down: the embedder in TF32, the language models with
fp8 weights, and reads the same numbers; it has to come out not correct.
"""
from __future__ import annotations

import numpy as np
import torch

from . import prompts, reference
from .tokenizer import HashWordTokenizer

EXACT_AT = 0.9999                     # RouterConfig's exact threshold
ROUTE_EPS = 1e-4
MISS, TWEAK, EXACT = 0, 1, 2
NUMBERS = ("embed_err", "score_err", "top1_err", "mismatch", "small_gap", "big_gap",
           "small_gap_mean", "big_gap_mean")


def choose_sample(log, window_ids, seed: int, per_kind: int = 2):
    """Dispatches whose generation is held to the reference: the one that
    served the most tokens, then random ones (from the seed) until each of
    the two models has ``per_kind`` generate calls."""
    rng = np.random.default_rng([seed, 7])
    ids = list(window_ids)
    if not ids:
        return []
    served = lambda i: sum(int(c["lengths"].sum()) for k in ("small", "big")
                           for c in log.dispatches[i][k])
    out = [max(ids, key=served)]
    for kind in ("big", "small"):
        have = sum(len(log.dispatches[i][kind]) for i in out)
        for i in rng.permutation(ids):
            if have >= per_kind:
                break
            if int(i) not in out and log.dispatches[int(i)][kind]:
                out.append(int(i))
                have += len(log.dispatches[int(i)][kind])
    return out


def bank_rows(engine, log, sample):
    """The bank rows the inserts of the sampled dispatches wrote, read back
    from the program's state after the window (device -> host)."""
    slots = []
    for i in sample:
        for ins in log.dispatches[i]["inserts"]:
            slots += ins["slots"][:ins["count"]].tolist()
    if not slots:
        return {}
    st = engine.bank.state
    at = torch.tensor(slots, device=st["emb"].device).long()
    rows = {k: st[k][at].cpu().numpy() for k in ("emb", "q_tokens", "q_mask", "r_tokens",
                                                 "r_mask")}
    return {s: {k: v[j] for k, v in rows.items()} for j, s in enumerate(slots)}


def _visible(row, n, ended):
    return [int(t) for t in row[:n - 1 if ended else n]]


class Reference:
    def __init__(self, stack, device, control: bool):
        self.cfg = stack.cfg
        self.w = {"big": stack.big, "small": stack.small, "emb": stack.embedder}
        self.tok = HashWordTokenizer(self.cfg["small"]["vocab_size"])
        self.device = device
        self.control = control

    def embed(self, texts, tf32=False):
        out = []
        with torch.no_grad():
            for i in range(0, len(texts), 2048):
                t, m = self.tok.encode_batch(texts[i:i + 2048],
                                             self.cfg["serving"]["max_query_len"])
                out.append(reference.encode(self.w["emb"], torch.from_numpy(t).long().to(
                    self.device), torch.from_numpy(m).to(self.device), self.cfg["embedder"],
                    tf32=tf32))
        return torch.cat(out) if out else torch.zeros(0, self.cfg["embedder"]["d_model"],
                                                      device=self.device)

    def gaps(self, kind, seqs, prompt_len, out, lengths, rows):
        """The gap of every served token of ``rows`` (the program's, or under
        the control the fp8 model's own choices), a 1-D tensor."""
        cfg = self.cfg[kind]
        mnt = out.shape[1]
        dev = self.device
        seqs = torch.from_numpy(np.ascontiguousarray(seqs)).long().to(dev)
        at = (prompt_len - 1 + torch.arange(mnt, device=dev))[None].expand(seqs.shape[0], mnt)
        moe = bool(cfg.get("num_experts"))
        keep = slice(None) if moe else slice(0, rows)
        with torch.no_grad(), reference.matmul_precision(False):
            ref = _chunked(self.w[kind], cfg, seqs[keep], prompt_len, at[keep], None, moe)
            served = torch.from_numpy(np.ascontiguousarray(out)).long().to(dev)[keep]
            if self.control:
                ctl = _chunked(self.w[kind], cfg, seqs[keep], prompt_len, at[keep], "fp8", moe)
                served = ctl.argmax(-1)
            g = reference.served_gaps(ref, served)[:rows]
        mask = torch.arange(mnt, device=dev)[None] < torch.from_numpy(
            np.asarray(lengths[:rows])).to(dev)[:, None]
        return g[mask]


def _chunked(weights, cfg, seqs, prompt_len, at, quant, moe, budget=2 ** 31):
    """lm_logits over rows in chunks whose attention scores fit ``budget``
    bytes (a MoE call in one piece: its groups span the rows)."""
    per_row = cfg["num_heads"] * seqs.shape[1] ** 2 * 4 * 3
    step = seqs.shape[0] if moe else max(1, budget // per_row)
    return torch.cat([reference.lm_logits(weights, cfg, seqs[i:i + step], prompt_len,
                                          at[i:i + step], quant)
                      for i in range(0, seqs.shape[0], step)])


def run_check(stack, traffic, window_ids, sample, rows_read, seed, device, control=False):
    """Returns ({number: value}, {detail: value})."""
    log = stack.log
    ref = Reference(stack, device, control)
    serving = stack.cfg["serving"]
    mnt = serving["max_new_tokens"]
    tweak_at = serving["tweak_threshold"]
    det = {"route": 0, "slot": 0, "exact": 0, "prompt": 0, "answer": 0, "row": 0,
           "unserved": 0, "rows_checked": 0, "tokens_checked": {"big": 0, "small": 0},
           "off_argmax": {"big": 0, "small": 0}}
    gap_sums = {"big": 0.0, "small": 0.0}
    # the reference's bank: every entry in insert order (FIFO slots 0, 1, ...)
    entries = [(prompts.preprocess(q), r) for q, r in traffic.warm]
    before = {}
    for d in log.dispatches:
        before[d["index"]] = len(entries)
        res = d["result"]
        dec = d["route"]["dec"].cpu().numpy()
        miss = [i for i in range(len(dec)) if dec[i] == MISS]
        want = list(range(len(entries), len(entries) + len(miss)))
        got = [s for ins in d["inserts"] for s in ins["slots"][:ins["count"]].tolist()]
        det["slot"] += sum(a != b for a, b in zip(want, got)) + abs(len(want) - len(got))
        entries += [(prompts.preprocess(d["texts"][i]), res.responses[i]) for i in miss]
    bank = ref.embed([e[0] for e in entries], tf32=control)
    refbank = ref.embed([e[0] for e in entries]) if control else bank
    nums = dict.fromkeys(NUMBERS, 0.0)
    for i in window_ids:
        d = log.dispatches[i]
        if d["route"] is None or d["route"]["rows"] != len(d["texts"]):
            det["unserved"] += len(d["texts"]) - (d["route"] or {"rows": 0})["rows"]
            continue
        pre = [prompts.preprocess(t) for t in d["texts"]]
        rq = ref.embed(pre)
        n_valid = before[i]
        valid = torch.ones(n_valid, dtype=torch.bool, device=device)
        pdec = d["route"]["dec"].cpu().numpy()
        pslot = d["route"]["idx"][:, 0].long()
        if control:
            q = ref.embed(pre, tf32=True)
            if n_valid:
                s, ix = reference.lookup(bank[:n_valid], valid, q, 1)
                score, slot = s[:, 0], ix[:, 0]
            else:
                score = torch.full((len(pre),), -float("inf"), device=device)
                slot = torch.full((len(pre),), -1, dtype=torch.long, device=device)
            dec = _decide(score, tweak_at)
        else:
            q, score, slot, dec = d["route"]["q"], d["route"]["scores"][:, 0], pslot, pdec
        nums["embed_err"] = max(nums["embed_err"], float((q - rq).abs().max()))
        if n_valid:
            rbest = reference.lookup(refbank[:n_valid], valid, rq, 1)[0][:, 0]
        else:
            rbest = torch.full((len(pre),), -float("inf"), device=device)
        ok = (slot >= 0) & (slot < n_valid)
        det["slot"] += int((~ok & torch.from_numpy(dec != MISS).to(device)).sum())
        if bool(ok.any()):
            mine = (rq * refbank[slot.clamp(0, n_valid - 1)]).sum(-1)
            nums["score_err"] = max(nums["score_err"], float((score - mine).abs()[ok].max()))
            nums["top1_err"] = max(nums["top1_err"], float((score - rbest).abs()[ok].max()))
        rdec = _decide(rbest, tweak_at)
        near = (torch.minimum((rbest - EXACT_AT).abs(), (rbest - tweak_at).abs())
                < ROUTE_EPS).cpu().numpy()
        det["route"] += int(((rdec != dec) & ~near).sum())
        det["rows_checked"] += len(pre)
        if not control:
            sl = pslot.cpu().numpy()
            for j in np.nonzero(pdec == EXACT)[0]:
                det["exact"] += d["result"].responses[j] != entries[int(sl[j])][1]
        if i in sample:
            _generation(ref, d, pdec, pslot.cpu().numpy(), pre, entries, rows_read, rq, nums,
                        det, serving, mnt, control, gap_sums)
    for kind in ("big", "small"):
        nums[f"{kind}_gap_mean"] = gap_sums[kind] / max(det["tokens_checked"][kind], 1)
    nums["mismatch"] = float(det["slot"] + det["route"] + det["exact"] + det["prompt"]
                             + det["answer"] + det["row"] + det["unserved"])
    return nums, det


def _decide(best, tweak_at):
    """The router's rule at the default operating point, on the host."""
    return torch.where(best >= EXACT_AT, EXACT, torch.where(best >= tweak_at, TWEAK,
                                                            MISS)).cpu().numpy()


def _generation(ref, d, dec, slot, pre, entries, rows_read, rq, nums, det, serving, mnt,
                control, gap_sums):
    tok = ref.tok
    small = ref.cfg["small"]
    calls = {"big": [], "small": []}
    miss = [j for j in range(len(pre)) if dec[j] == MISS]
    if miss:
        calls["big"].append((prompts.miss_call(tok, [pre[j] for j in miss],
                                               serving["max_query_len"]), miss))
    tw = [j for j in range(len(pre)) if dec[j] == TWEAK]
    if tw:
        prefixed = small.get("attention_impl") == "xla_flash" and not small.get("sliding_window")
        rows = [(pre[j], *entries[int(slot[j])]) for j in tw]
        for c in prompts.tweak_calls(tok, rows, small["max_seq_len"], mnt, prefixed):
            calls["small"].append((c, [tw[r] for r in c["rows"]]))
    for kind in ("big", "small"):
        got = d[kind]
        if len(got) != len(calls[kind]):
            det["prompt"] += 1
            continue
        for (want, js), rec in zip(calls[kind], got):
            if (rec["prefix"] != list(want["prefix"])
                    or np.asarray(rec["tokens"]).shape != want["tokens"].shape
                    or not np.array_equal(np.asarray(rec["tokens"]), want["tokens"])):
                det["prompt"] += 1
                continue
            out, lengths, ended = rec["out"], rec["lengths"], rec["ended"]
            if not control:
                for r, j in enumerate(js):
                    vis = _visible(out[r], int(lengths[r]), bool(ended[r]))
                    det["answer"] += d["result"].responses[j] != tok.decode_ids(vis)
                    if kind == "big" and j in miss:
                        det["row"] += _row_wrong(rows_read, d, miss.index(j), pre[j], vis,
                                                 rq[j], tok, serving, nums)
            p = len(want["prefix"])
            seqs = np.concatenate([np.broadcast_to(np.asarray(want["prefix"], np.int64),
                                                   (out.shape[0], p)),
                                   want["tokens"].astype(np.int64),
                                   out[:, :mnt - 1].astype(np.int64)], axis=1)
            g = ref.gaps(kind, seqs, p + want["tokens"].shape[1], out, lengths, len(js))
            if g.numel():
                nums[f"{kind}_gap"] = max(nums[f"{kind}_gap"], float(g.max()))
                gap_sums[kind] += float(g.sum())
                det["off_argmax"][kind] += int((g > 0).sum())
            det["tokens_checked"][kind] += int(g.numel())


def _row_wrong(rows_read, d, k, query, vis, rq, tok, serving, nums):
    """The k-th row the dispatch's insert wrote, against the reference."""
    slots = [s for ins in d["inserts"] for s in ins["slots"][:ins["count"]].tolist()]
    if k >= len(slots) or slots[k] not in rows_read:
        return 1
    row = rows_read[slots[k]]
    qt, qm = tok.encode_batch([query], row["q_tokens"].shape[0])
    rt = np.zeros_like(row["r_tokens"])
    rm = np.zeros_like(row["r_mask"])
    n = min(len(vis), rt.shape[0])
    rt[:n], rm[:n] = vis[:n], 1.0
    emb = torch.from_numpy(row["emb"]).to(rq.device)
    nums["embed_err"] = max(nums["embed_err"], float((emb - rq).abs().max()))
    return int(not (np.array_equal(row["q_tokens"], qt[0]) and np.array_equal(row["q_mask"], qm[0])
                    and np.array_equal(row["r_tokens"], rt) and np.array_equal(row["r_mask"], rm)))
