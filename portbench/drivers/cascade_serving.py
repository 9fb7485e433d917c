"""Closed-loop bursts of requests through ``repro_torch``'s cascade server.

The entry the window drives is ``CascadeServer.run``, fed one burst at a
time: a burst is one fleet tick's worth of queries escalated from the
cameras, all submitted at once; the next goes in when ``run`` returns
(``run`` takes no arrivals while it runs).  Each request is triaged by
the edge model (``submit``), and those the edge cannot settle are
prefilled into a free slot of the cloud's decode batch (``admit``) and
decoded a token a tick (``step``) until they have their answer.

Set-up draws the weights on the device from the seed, fixes the edge
thresholds of each of the mix's first ``threshold_bursts`` bursts from
the reference's confidences over that burst (so that the mix's
``edge_settled`` share of every burst settles at the edge, half accepted
and half rejected, and every seed sends the cloud as many requests;
later bursts take the thresholds pooled over those), builds the server
and warms up each
shape the mix uses: every prompt length a burst holds (the same in
every burst) through the edge and an admission, and a decode tick of
the whole batch, so that no first use of a shape (cuBLAS's choice of a
kernel, the allocator's first blocks of a size) falls in the window.
The window then runs bursts 0, 1, ... until ``--seconds`` have passed
and the burst in flight is done.

Spans come from this file, around the server's public calls (``submit``,
``edge_conf``, ``engine.admit``, ``engine.step``): the host clock after
each returns, and each of them waits for the device (it reads a
confidence or an argmax back).  With ``trace``, one burst of the window
(the second) runs under the profiler (``devtrace``), up to
``TRACE_MAX_S`` seconds of it.

After the window the program's state is freed and the plain reference
(``reference/model.py``) reads the run: every request's confidence and
route, and the served tokens of a sample of the finished requests drawn
from the seed (the longest prompt, the longest answer and a request of
every slot of the decode batch in it), each beside the logit the
program chose it by (``Tap``).
"""
from __future__ import annotations

import dataclasses
import gc
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import devtrace, generator, weights
from portbench.harness import Cell, Outcome
from portbench.reference import model as REF

#: seconds of a traced burst under the profiler, at most
TRACE_MAX_S = 30.0
#: the burst a traced run profiles
TRACE_BURST = 1


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def thresholds(conf: List[float], share: float) -> Dict[str, float]:
    """alpha and beta halfway between neighbouring confidences, so that
    ``share`` of them settles at the edge, half above alpha and half
    below beta."""
    c = sorted(conf)
    k = max(1, int(round(share * len(c) / 2)))
    return {"alpha": (c[-k - 1] + c[-k]) / 2, "beta": (c[k - 1] + c[k]) / 2}


class Tap:
    """Spans and outputs of one server, recorded around its public calls,
    and the logit of each token the cloud model chose (the largest of the
    logits that ``transformer.prefill`` and ``decode_step`` return: the
    engine's tokens are their argmax), kept on the device until the
    window closes (``served_logits``)."""

    def __init__(self, server, on_step=None):
        self.on_step = on_step
        self.logits: List[tuple] = []        # (rids, (rows,) max logits)
        self._admitting, self._slot_rids = None, ()
        self.submits: List[tuple] = []       # (rid, t0, t1)
        self.admits: List[tuple] = []        # (rid, t0, t1, S)
        self.steps: List[tuple] = []         # (t0, t1, active, slots)
        self.conf: Dict[int, float] = {}
        self.slot: Dict[int, int] = {}       # rid -> slot it was admitted to
        self.first: Dict[int, float] = {}
        self.done: Dict[int, float] = {}
        self._rid = None
        eng = server.engine
        submit, edge_conf = server.submit, server.edge_conf
        admit, step = eng.admit, eng.step

        def tapped_edge_conf(tokens):
            c = edge_conf(tokens)
            self.conf[self._rid] = c
            return c

        def tapped_submit(req):
            self._rid = req.rid
            t0 = time.perf_counter()
            submit(req)
            t1 = time.perf_counter()
            self.submits.append((req.rid, t0, t1))
            if req.route != "cloud":
                self.done[req.rid] = t1

        def tapped_admit(req):
            self._admitting = req.rid
            t0 = time.perf_counter()
            ok = admit(req)
            if ok:
                t1 = time.perf_counter()
                self.admits.append((req.rid, t0, t1, len(req.tokens)))
                self.first[req.rid] = t1
                self.slot[req.rid] = next(
                    i for i, sl in enumerate(eng.slots) if sl.rid == req.rid)
            return ok

        def tapped_step():
            active, slots = eng.active, len(eng.slots)
            self._slot_rids = tuple(sl.rid for sl in eng.slots)
            t0 = time.perf_counter()
            done = step()
            t1 = time.perf_counter()
            self.steps.append((t0, t1, active, slots))
            for rid, _ in done:
                self.done[rid] = t1
            if self.on_step is not None:
                self.on_step(t1)
            return done

        server.edge_conf, server.submit = tapped_edge_conf, tapped_submit
        eng.admit, eng.step = tapped_admit, tapped_step

    def prefill(self, fn):
        def tapped(*a, **kw):
            out = fn(*a, **kw)
            self.logits.append(((self._admitting,), out[0].amax(-1)))
            return out
        return tapped

    def decode_step(self, fn):
        def tapped(*a, **kw):
            out = fn(*a, **kw)
            self.logits.append((self._slot_rids, out[0].amax(-1)))
            return out
        return tapped

    def served_logits(self) -> Dict[int, List[float]]:
        """Each request's chosen-token logits, in the order served."""
        if not self.logits:
            return {}
        vals = torch.cat([t.reshape(-1) for _, t in self.logits]
                         ).float().cpu().tolist()
        out: Dict[int, List[float]] = {}
        at = 0
        for rids, _ in self.logits:
            for rid in rids:
                if rid is not None and rid >= 0:
                    out.setdefault(rid, []).append(vals[at])
                at += 1
        return out


@dataclasses.dataclass
class Setup:
    """The server, the ids both models know, the edge thresholds of each
    of the first bursts and pooled over them, and the reference's
    (confidence, router margin) of those bursts' requests."""
    server: object
    vocab: int
    th: List[Dict[str, float]]
    th_pooled: Dict[str, float]
    ref_conf: Dict[int, tuple]

    def th_of(self, burst: int) -> Dict[str, float]:
        """The thresholds burst ``burst`` is triaged by."""
        return self.th[burst] if burst < len(self.th) else self.th_pooled


def setup(cell: Cell, seed: int, dev: torch.device) -> Setup:
    """Weights, thresholds, the server and its warm-up."""
    from repro_torch.core.thresholds import ThresholdState
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.engine import CascadeServer, Request
    cfg, mix = cell.config, cell.mix
    m, e, init = cfg["model"], cfg["edge"], cfg["init"]
    vocab = min(m["vocab_size"], e["vocab_size"])
    ref_conf, th = {}, []
    edge_ref = weights.make(e, init, seed, "edge", dev)
    f32 = REF.Precision("f32")
    for b in range(mix["threshold_bursts"]):
        conf = []
        for s in generator.burst(mix, seed, b, vocab):
            ref_conf[s.rid] = REF.edge_conf(
                e, edge_ref, torch.as_tensor(s.tokens, device=dev), f32)
            conf.append(ref_conf[s.rid][0])
        th.append(thresholds(conf, mix["edge_settled"]))
    del edge_ref
    pooled = thresholds([c for c, _ in ref_conf.values()],
                        mix["edge_settled"])
    server = CascadeServer(
        ModelConfig(**e), weights.make(e, init, seed, "edge", dev),
        ModelConfig(**m), weights.make(m, init, seed, "cloud", dev),
        slots=mix["slots"], cache_len=mix["cache_len"],
        thresholds=ThresholdState(**th[0]), device=dev)
    rng = np.random.default_rng(0)
    eng = server.engine
    with torch.no_grad():
        for i, n in enumerate(sorted(set(generator.quantile_lengths(
                *mix["prompt_tokens"], mix["burst"])), reverse=True)):
            req = Request(rid=-1 - i, tokens=rng.integers(
                0, vocab, size=n).astype(np.int32), max_new=1)
            server.edge_conf(req.tokens)
            if not eng.admit(req):
                eng.step()
                eng.admit(req)
        while eng.active:
            eng.step()
    _sync(dev)
    gc.collect()
    return Setup(server, vocab, th, pooled, ref_conf)


@dataclasses.dataclass
class Window:
    """What the window served, on the host clock."""
    t0: float
    t1: float
    bursts: List[tuple]                      # (index, t_submit, t_done)
    requests: Dict[int, Dict]
    tap: Tap
    results: Dict[int, object]
    trace: Optional[Dict] = None


def window(st: Setup, cell: Cell, seed: int, seconds: float,
           dev: torch.device, trace: bool = False,
           bursts: Optional[int] = None) -> Window:
    """Bursts until ``seconds`` have passed (or ``bursts`` bursts)."""
    from repro_torch.core.thresholds import ThresholdState
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Request
    traced = {"on": None, "done": None}

    def stop_trace():
        traced["on"].stop()
        traced["done"], traced["on"] = traced["on"], None

    def on_step(t):
        if traced["on"] is not None and t - traced["on"].t0 >= TRACE_MAX_S:
            stop_trace()

    tap = Tap(st.server, on_step if trace else None)
    reqs: Dict[int, Dict] = {}
    done_bursts = []
    fns = (T.prefill, T.decode_step)
    T.prefill, T.decode_step = tap.prefill(fns[0]), tap.decode_step(fns[1])
    try:
        t0 = time.perf_counter()
        k = 0
        while True:
            specs = generator.burst(cell.mix, seed, k, st.vocab)
            batch = [Request(rid=s.rid, tokens=s.tokens, max_new=s.max_new)
                     for s in specs]
            st.server.th = ThresholdState(**st.th_of(k))
            if trace and k == TRACE_BURST and dev.type == "cuda":
                traced["on"] = devtrace.Slice()
                traced["on"].start()
            tb = time.perf_counter()
            for s in specs:
                reqs[s.rid] = {"rid": s.rid, "burst": k, "t_submit": tb,
                               "prompt_len": len(s.tokens),
                               "max_new": s.max_new, "tokens": s.tokens}
            st.server.run(batch)
            te = time.perf_counter()
            if traced["on"] is not None:
                stop_trace()
            done_bursts.append((k, tb, te))
            k += 1
            if k == bursts or (bursts is None and te - t0 >= seconds):
                break
    finally:
        T.prefill, T.decode_step = fns
    _sync(dev)
    t1 = time.perf_counter()
    w = Window(t0, t1, done_bursts, reqs, tap, st.server.results)
    if traced["done"] is not None:
        sl = traced["done"]
        tr = sl.read()
        tr["admits"] = [S for _, a, b, S in tap.admits
                        if sl.t0 <= a and b <= sl.t1]
        tr["submits"] = [len(reqs[rid]["tokens"]) for rid, a, b in
                         tap.submits if sl.t0 <= a and b <= sl.t1]
        spans = {"decode step (host)": [(a, b) for a, b, _, _ in tap.steps],
                 "admission (host)": [(a, b) for _, a, b, _ in tap.admits],
                 "edge submit (host)": [(a, b) for _, a, b in tap.submits]}
        tr["breakdown"] = devtrace.breakdown(tr, spans)
        w.trace = tr
    chosen = tap.served_logits()
    for rid, r in reqs.items():
        res = w.results.get(rid)
        r["route"] = getattr(res, "route", None)
        r["output"] = getattr(res, "output", None)
        r["t_first"] = tap.first.get(rid)
        r["t_done"] = tap.done.get(rid)
        r["conf"] = tap.conf.get(rid)
        r["slot"] = tap.slot.get(rid)
        r["logits"] = chosen.get(rid, [])
    return w


def free(st: Setup, dev: torch.device) -> None:
    """Drop the program's state so the reference runs in its memory."""
    st.server = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _answer_ok(r: Dict, vocab: int) -> bool:
    out = r["output"]
    if out is None or r["route"] not in ("edge_accept", "edge_reject",
                                         "cloud"):
        return False
    out = np.asarray(out).ravel()
    if r["route"] == "edge_accept":
        return out.tolist() == [1]
    if r["route"] == "edge_reject":
        return out.tolist() == [0]
    return len(out) == r["max_new"] and bool(
        ((out >= 0) & (out < vocab)).all())


def sample(w: Window, cell: Cell, seed: int, vocab: int) -> List[int]:
    """The cloud requests whose served tokens the reference reads: the
    longest prompt, the longest answer, one request of every slot of the
    decode batch that served one (so that a fault confined to one slot
    is read), and the rest drawn from the seed."""
    served = sorted((r for r in w.requests.values()
                     if r["route"] == "cloud" and _answer_ok(r, vocab)),
                    key=lambda r: r["rid"])
    if not served:
        return []
    pick = {max(served, key=lambda r: (r["prompt_len"], r["rid"]))["rid"],
            max(served, key=lambda r: (r["max_new"], r["rid"]))["rid"]}
    rng = np.random.default_rng(weights.derive_seed(seed, "check"))
    by_slot: Dict[int, List[int]] = {}
    for r in served:
        by_slot.setdefault(r["slot"], []).append(r["rid"])
    for slot in sorted(by_slot, key=lambda x: (x is None, x or 0)):
        if not pick.intersection(by_slot[slot]):
            pick.add(int(rng.choice(by_slot[slot])))
    rest = [r["rid"] for r in served if r["rid"] not in pick]
    n = max(0, min(cell.mix["check_requests"] - len(pick), len(rest)))
    pick.update(int(x) for x in rng.choice(rest, size=n, replace=False))
    return sorted(pick)


def check(w: Window, st: Setup, cell: Cell, seed: int, dev: torch.device,
          control: Optional[str] = None, detail: bool = False) -> Dict:
    """The numbers read by the reference after the window:

    * ``answer_miss``: requests unanswered, or answered out of form;
    * ``route_miss``: routes other than the reference's confidence gives
      under the request's burst's thresholds, where that confidence is
      not within the confidence limit of a threshold (within
      ``edge_tie_band`` for a near-tie request);
    * ``conf_err_max``: the widest gap between the program's edge
      confidence and the reference's, over the requests whose edge path
      held no router near-tie (two experts within the checks'
      ``edge_router_tie`` of the top-k boundary; without experts, every
      request): a near-tie may route the other way in any f32 program;
    * ``logit_err_p50``: the median, over the served tokens of the
      sample, of the gap between the program's logit of each token it
      chose and the reference's logit of that token (``_p75``, ``_p90``
      and ``_max`` beside it);
    * ``token_miss``: served tokens of the sample whose reference logit
      lies more than the checks' ``token_band`` below the reference's
      best: a token the program's logits, within their error of the
      reference's, could not have put first;
    * ``gap_max``, ``gap_mean``: how far each served token's logit lies
      below the reference's best.

    A cell's ``checks/<name>.json`` says which are compared.  With
    ``control``, the same numbers of the reference in that precision put
    in the program's place (``control_*``); with ``detail``, the readings
    of each request."""
    cfg = cell.config
    m, e, init = cfg["model"], cfg["edge"], cfg["init"]
    V = m["vocab_size"]
    f32 = REF.Precision("f32")
    low = REF.Precision(control) if control else None
    limits = cell.checks["limits"]
    edge_tie = cell.checks.get("edge_router_tie", 0.0)
    token_band = cell.checks.get("token_band", 0.0)
    edge_ref = weights.make(e, init, seed, "edge", dev)
    out: Dict[str, float] = {"answer_miss": 0, "route_miss": 0,
                             "conf_err_max": 0.0, "tie_requests": 0}
    ctl_conf, edge_rows = 0.0, []
    for r in w.requests.values():
        if not _answer_ok(r, V):
            out["answer_miss"] += 1
        toks = torch.as_tensor(r["tokens"], device=dev)
        ref, margin = st.ref_conf.get(r["rid"]) or REF.edge_conf(
            e, edge_ref, toks, f32)
        err = float("inf") if r["conf"] is None else abs(r["conf"] - ref)
        clear = margin >= edge_tie
        if clear:
            out["conf_err_max"] = max(out["conf_err_max"], err)
        else:
            out["tie_requests"] += 1
        th = st.th_of(r["burst"])
        want = "edge_accept" if ref > th["alpha"] else (
            "edge_reject" if ref < th["beta"] else "cloud")
        near = min(abs(ref - th["alpha"]), abs(ref - th["beta"]))
        route_band = limits.get("conf_err_max", 0.0) if clear else \
            cell.checks.get("edge_tie_band", 0.0)
        if r["route"] != want and near > route_band:
            out["route_miss"] += 1
        ctl = None
        if low is not None:
            ctl = abs(REF.edge_conf(e, edge_ref, toks, low)[0] - ref)
            if clear:
                ctl_conf = max(ctl_conf, ctl)
        edge_rows.append((r["rid"], r["prompt_len"], err, margin, ctl))
    del edge_ref
    cloud_ref = weights.make(m, init, seed, "cloud", dev)
    errs, gaps, c_errs, c_gaps, per_req = [], [], [], [], []
    for rid in sample(w, cell, seed, V):
        r = w.requests[rid]
        served = np.asarray(r["output"])
        s = REF.request_stats(
            m, cloud_ref, torch.as_tensor(r["tokens"], device=dev),
            torch.as_tensor(served, device=dev), low)
        prog = r["logits"]
        e_r = [abs(a - b) for a, b in zip(prog, s["ref_at"])] \
            if len(prog) == len(served) else [float("inf")] * len(served)
        errs += e_r
        gaps += s["gap"]
        if low is not None:
            c_errs += [abs(a - b) for a, b in zip(s["control_at"],
                                                  s["control_ref_at"])]
            c_gaps += s["control_gap"]
        per_req.append({"rid": rid, "prompt_len": r["prompt_len"],
                        "slot": r["slot"],
                        "served": len(served), "logit_err": e_r,
                        "control_logit_err": [
                            abs(a - b) for a, b in zip(
                                s.get("control_at", []),
                                s.get("control_ref_at", []))],
                        "gaps": s["gap"], "control_gaps": s.get(
                            "control_gap"),
                        "router_margin": s["router_margin"],
                        "position_margin": s["position_margin"],
                        "dropped_share": s["dropped_share"]})
    del cloud_ref
    out.update(_cloud_numbers(errs, gaps))
    out["token_miss"] = sum(g > token_band for g in gaps)
    if low is not None:
        out["control_conf_err_max"] = ctl_conf
        out["control_token_miss"] = sum(g > token_band for g in c_gaps)
        out.update({"control_" + k: v for k, v in
                    _cloud_numbers(c_errs, c_gaps).items()
                    if k != "compared_tokens"})
    if detail:
        out["requests"] = per_req
        out["edge"] = edge_rows
    return out


def _cloud_numbers(errs: List[float], gaps: List[float]) -> Dict:
    if not errs:
        inf = float("inf")
        return {"logit_err_p50": inf, "logit_err_p75": inf,
                "logit_err_p90": inf,
                "logit_err_max": inf, "gap_max": inf, "gap_mean": inf,
                "compared_tokens": 0}
    return {"logit_err_p50": float(np.percentile(errs, 50)),
            "logit_err_p75": float(np.percentile(errs, 75)),
            "logit_err_p90": float(np.percentile(errs, 90)),
            "logit_err_max": max(errs), "gap_max": max(gaps),
            "gap_mean": float(np.mean(gaps)), "compared_tokens": len(errs)}


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        dev: torch.device, t_start: float) -> Outcome:
    """One run of the cell: set-up, the window, the check."""
    with torch.no_grad():
        st = setup(cell, seed, dev)
        setup_s = time.perf_counter() - t_start
        w = window(st, cell, seed, seconds, dev, trace=trace)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    free(st, dev)
    readings = check(w, st, cell, seed, dev)
    ns = types.SimpleNamespace(
        setup_s=setup_s, window_s=w.t1 - w.t0, requests=w.requests,
        submits=w.tap.submits, admits=w.tap.admits, steps=w.tap.steps,
        model=cell.config["model"], edge=cell.config["edge"],
        trace=w.trace)
    return Outcome(run=ns, readings=readings, attempted=len(w.requests),
                   failed=int(readings["answer_miss"]), peak_bytes=peak,
                   trace=w.trace,
                   extra={"bursts_s": [te - tb for _, tb, te in w.bursts]})


def window_only(cell: Cell, seed: int, dev: torch.device, bursts: int):
    """Set-up and ``bursts`` bursts, the program's state freed after:
    (Setup, Window) for ``check`` to read."""
    with torch.no_grad():
        st = setup(cell, seed, dev)
        w = window(st, cell, seed, 0.0, dev, bursts=bursts)
    free(st, dev)
    return st, w
