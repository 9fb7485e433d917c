"""The port's flight recorder (``repro_torch.tracing``) on the serving
path: the span tree a ``CascadeServer.run`` records, the counters of
each decode tick, no device work added by recording, and the bounded
buffer.

Tiny seeded models on the CPU (the reduced qwen1.5-0.5b and
granite-moe-1b-a400m, each behind its edge variant); each test records
into a fresh ``Recorder`` of its own.
"""
import collections
import sys
import threading
from time import perf_counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core.thresholds import ThresholdState
from repro_torch.models import layers as L
from repro_torch.models import meta as M
from repro_torch.serving.engine import CascadeServer, DecodeEngine, Request

ARCHS = ["qwen1.5-0.5b", "granite-moe-1b-a400m"]
SLOTS = 2


def _fresh(monkeypatch):
    """A fresh recorder, switched on, for the rest of this test."""
    r = tracing.Recorder()
    monkeypatch.setattr(tracing, "RECORDER", r)
    monkeypatch.setattr(tracing, "ENABLED", True)
    return r


@pytest.fixture
def rec(monkeypatch):
    return _fresh(monkeypatch)


def _params(cfg, seed):
    return M.init_params(cfg, torch.Generator().manual_seed(seed))


def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=8 + 2 * i).astype(np.int32)
            for i in range(n)]


def _server(arch):
    """A two-slot server whose thresholds settle the most and the least
    confident of eight prompts at the edge and send six to the cloud."""
    cfg = get_config(arch).reduced()
    edge = cfg.edge_variant()
    srv = CascadeServer(edge, _params(edge, 0), cfg, _params(cfg, 1),
                        slots=SLOTS, cache_len=64, device="cpu")
    prompts = _prompts(8, min(cfg.vocab_size, edge.vocab_size))
    c = sorted(srv.edge_conf(p) for p in prompts)
    srv.th = ThresholdState(alpha=(c[-1] + c[-2]) / 2,
                            beta=(c[0] + c[1]) / 2)
    reqs = [Request(rid=i, tokens=p, max_new=3 + i % 3)
            for i, p in enumerate(prompts)]
    return cfg, edge, srv, reqs


def _inside(child, parent):
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


@pytest.mark.parametrize("arch", ARCHS)
def test_a_run_records_the_span_tree(arch, monkeypatch):
    cfg, edge, srv, reqs = _server(arch)
    rec = _fresh(monkeypatch)
    ticks0 = srv.engine.ticks
    t_before = perf_counter()
    srv.run(reqs)
    t_after = perf_counter()
    snap = tracing.snapshot()
    spans = {s.sid: s for s in snap.spans}
    by = collections.defaultdict(list)
    for s in snap.spans:
        by[s.name].append(s)
    cloud = sorted(r.rid for r in reqs if r.route == "cloud")
    assert len(cloud) == 6 and len(reqs) - len(cloud) == 2
    assert sorted(s.rid for s in by["edge"]) == list(range(len(reqs)))
    assert sorted(s.rid for s in by["admit"]) == cloud
    assert len(by["tick"]) == srv.engine.ticks - ticks0
    # the roots, and each child once under its parent, inside it
    roots = {"edge", "admit", "tick"}
    assert {s.name for s in snap.spans if s.parent is None} == roots
    children = {"edge": ("edge.launch", "edge.readback"),
                "admit": ("admit.prefill", "admit.first_token",
                          "admit.slot_copy"),
                "tick": ("tick.launch", "tick.readback",
                         "tick.bookkeeping")}
    for root, kids in children.items():
        for p in by[root]:
            got = sorted(s.name for s in snap.spans if s.parent == p.sid)
            assert got == sorted(kids)
    for s in snap.spans:
        assert t_before <= s.t0 <= s.t1 <= t_after
        if s.parent is not None:
            parent = spans[s.parent]
            assert _inside(s, parent), (s, parent)
            assert s.rid == parent.rid
            assert s.name.startswith(parent.name + ".") or \
                (s.name == "moe" and parent.name in tracing.LAUNCH)
    # MoE: a ``moe`` span a layer under each launch that runs the model
    moe = by["moe"]
    if cfg.num_experts:
        per = collections.Counter(spans[s.parent].name for s in moe)
        assert per["tick.launch"] == cfg.num_layers * len(by["tick"])
        assert per["admit.prefill"] == cfg.num_layers * len(cloud)
        assert per["edge.launch"] == (edge.num_layers * len(reqs)
                                      if edge.num_experts else 0)
    else:
        assert not moe
    # a request waits from the end of its triage to its admission: the
    # last admitted waits out the others' decode ticks
    edge_of = {s.rid: s for s in by["edge"]}
    waits = sorted(a.t0 - edge_of[a.rid].t1 for a in by["admit"])
    assert waits[0] >= 0
    assert waits[-1] > sum(a.t1 - a.t0 for a in by["admit"]) / len(cloud)
    assert snap.evicted == 0 and rec.recorded == len(snap.spans) + len(
        snap.counts)


@pytest.mark.parametrize("arch", ARCHS)
def test_counters_at_each_decode_tick(arch, monkeypatch):
    """Each tick records the slots it ran that held a request
    (``tick.active``, on ``tick``) and, on MoE models, its layers' expert
    rows (``moe.slots``, on ``tick.launch``), once a counter at the
    span's close; no other span holds a count."""
    cfg, _, srv, reqs = _server(arch)
    _fresh(monkeypatch)
    srv.run(reqs)
    snap = tracing.snapshot()
    spans = {s.sid: s for s in snap.spans}
    once = collections.Counter((c.sid, c.name) for c in snap.counts)
    assert set(once.values()) == {1}
    on = collections.defaultdict(dict)
    for c in snap.counts:
        assert c.t == spans[c.sid].t1
        on[spans[c.sid].name][c.sid] = (c.name, c.value)
    ticks = [s.sid for s in snap.spans if s.name == "tick"]
    assert sorted(on["tick"]) == sorted(ticks)
    active = [v for n, v in on["tick"].values() if n == "tick.active"]
    assert len(active) == len(ticks) and set(active) <= {1, SLOTS}
    # every decode tick serves each admitted request one token after its
    # first (the prefill's)
    assert sum(active) == sum(r.max_new - 1 for r in reqs
                              if r.route == "cloud")
    launches = [s.sid for s in snap.spans if s.name == "tick.launch"]
    if cfg.num_experts:
        rows = cfg.num_layers * SLOTS * cfg.num_experts * L.moe_capacity(
            cfg, 1)
        assert on["tick.launch"] == {sid: ("moe.slots", rows)
                                     for sid in launches}
        assert set(on) == {"tick", "tick.launch"}
    else:
        assert set(on) == {"tick"}


def test_moe_slots_count_a_decode_steps_rows(rec):
    """A call of one token a row counts B*E*capacity into the span open
    around it, or at once outside any; a prompt's call counts nothing."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    p = _params(cfg, 1)["layers"]["moe"]
    lp = M.tree_map(lambda t: t[0], p)
    with tracing.span("outer"):
        L.moe_apply(cfg, lp, torch.randn(1, 64, cfg.d_model))
        L.moe_apply(cfg, lp, torch.randn(3, 1, cfg.d_model))
    L.moe_apply(cfg, lp, torch.randn(2, 1, cfg.d_model))
    snap = tracing.snapshot()
    assert [s.name for s in snap.spans] == ["moe", "moe", "outer", "moe"]
    outer = snap.spans[2]
    rows = cfg.num_experts * L.moe_capacity(cfg, 1)
    assert [(c.name, c.value, c.sid) for c in snap.counts] == [
        ("moe.slots", 3 * rows, outer.sid), ("moe.slots", 2 * rows, None)]
    assert snap.counts[0].t == outer.t1


class _Ops(TorchDispatchMode):
    """Counts the aten operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _engine_ops(cfg, params, prompts, on, monkeypatch):
    """The aten operators of an admission and of a decode tick, and the
    engine's tokens and cache after them, with the recorder on or off."""
    monkeypatch.setattr(tracing, "ENABLED", on)
    eng = DecodeEngine(cfg, params, slots=SLOTS, cache_len=64, device="cpu")
    assert eng.admit(Request(rid=0, tokens=prompts[0], max_new=4))
    with _Ops() as admit:
        assert eng.admit(Request(rid=1, tokens=prompts[1], max_new=4))
    with _Ops() as tick:
        eng.step()
    return admit.ops, tick.ops, eng.tokens.clone(), M.tree_map(
        torch.clone, eng.cache["layers"])


@pytest.mark.parametrize("arch", ARCHS)
def test_recording_adds_no_operator(arch, rec, monkeypatch):
    cfg = get_config(arch).reduced()
    params = _params(cfg, 1)
    prompts = _prompts(2, cfg.vocab_size)
    on = _engine_ops(cfg, params, prompts, True, monkeypatch)
    assert any(s.name == "tick.launch" for s in rec.snapshot().spans)
    n = rec.recorded
    off = _engine_ops(cfg, params, prompts, False, monkeypatch)
    assert rec.recorded == n
    assert on[0] == off[0] and sum(on[0].values()) > 0
    assert on[1] == off[1] and sum(on[1].values()) > 0
    assert torch.equal(on[2], off[2])
    for (_, a), (_, b) in zip(M.leaves(on[3]), M.leaves(off[3])):
        assert torch.equal(a, b)


def test_records_hold_host_numbers_only(rec):
    _, _, srv, reqs = _server("granite-moe-1b-a400m")
    srv.run(reqs)
    snap = tracing.snapshot()
    plain = (str, int, float, type(None))
    for r in snap.spans + snap.counts:
        assert all(type(v) in plain for v in r), r


def test_the_buffer_keeps_its_capacity_and_counts_what_it_evicts(
        monkeypatch):
    r = tracing.Recorder(capacity=5)
    monkeypatch.setattr(tracing, "RECORDER", r)
    ends = []
    for i in range(8):
        with tracing.span("s", rid=i):
            pass
        ends.append(tracing.snapshot().spans[-1].t1)
    snap = tracing.snapshot()
    assert [s.rid for s in snap.spans] == [3, 4, 5, 6, 7]
    assert snap.evicted == 3 and r.recorded == 8
    assert snap.evicted_until == ends[2]
    tracing.count("c", 7)
    snap = tracing.snapshot()
    assert len(snap.spans) + len(snap.counts) == 5 and snap.evicted == 4
    assert snap.evicted_until == ends[3]
    assert tracing.Recorder().snapshot().evicted_until == float("-inf")
    with pytest.raises(ValueError):
        tracing.Recorder(capacity=0)


def test_switched_off_nothing_is_recorded(rec, monkeypatch):
    monkeypatch.setattr(tracing, "ENABLED", False)
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a", rid=1):
        tracing.count("c", 1)
        tracing.leaf("b", perf_counter())
    assert rec.recorded == 0 and rec.snapshot().spans == []


def test_a_leaf_is_a_span_under_the_one_open(rec):
    """``leaf`` records what a ``with`` block of no children would: its
    parent and request id from the span open, from ``t0`` to now."""
    t0 = perf_counter()
    tracing.leaf("alone", t0)
    with tracing.span("outer", rid=6):
        t1 = perf_counter()
        tracing.leaf("inner", t1)
    alone, inner, outer = rec.snapshot().spans
    assert (alone.name, alone.parent, alone.rid, alone.t0) == (
        "alone", None, None, t0)
    assert (inner.name, inner.parent, inner.rid, inner.t0) == (
        "inner", outer.sid, 6, t1)
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert len({alone.sid, inner.sid, outer.sid}) == 3


def test_a_span_sums_its_counters_and_records_them_at_its_close(rec):
    with tracing.span("outer", rid=5):
        tracing.count("c", 2)
        with tracing.span("inner"):
            tracing.count("c", 1)
        tracing.count("c", 3)
        tracing.count("d", 4)
        assert [c.value for c in rec.snapshot().counts] == [1]
    tracing.count("c", 7)
    snap = rec.snapshot()
    inner, outer = snap.spans
    assert [(c.name, c.value, c.sid, c.t) for c in snap.counts[:3]] == [
        ("c", 1, inner.sid, inner.t1), ("c", 5, outer.sid, outer.t1),
        ("d", 4, outer.sid, outer.t1)]
    assert snap.counts[3][:2] == ("c", 7) and snap.counts[3].sid is None


def test_one_shared_object_nests_the_spans_of_a_name(rec):
    assert tracing.span("a") is tracing.span("a")
    assert tracing.span("a", rid=1) is not tracing.span("a", rid=1)
    with tracing.span("a", rid=3):
        with tracing.span("a"):
            with tracing.span("a"):
                pass
    inner, mid, outer = rec.snapshot().spans
    assert (inner.parent, mid.parent, outer.parent) == (mid.sid, outer.sid,
                                                        None)
    assert inner.rid == mid.rid == outer.rid == 3
    assert outer.t0 <= mid.t0 <= inner.t0 <= inner.t1 <= mid.t1 <= outer.t1


def test_each_thread_nests_its_own_spans(rec):
    """Threads record at once under a short switch interval: every span's
    parent is one of its own thread's, and none is lost."""
    n_threads, rounds = 8, 200
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for _ in range(rounds):
            with tracing.span("outer", rid=k):
                with tracing.span("inner"):
                    tracing.count("c", k)

    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    snap = rec.snapshot()
    spans = {s.sid: s for s in snap.spans}
    assert len(snap.spans) == 2 * n_threads * rounds
    assert rec.recorded == 3 * n_threads * rounds
    for s in snap.spans:
        if s.name == "inner":
            assert spans[s.parent].name == "outer"
            assert spans[s.parent].rid == s.rid
    for c in snap.counts:
        assert spans[c.sid].rid == c.value
