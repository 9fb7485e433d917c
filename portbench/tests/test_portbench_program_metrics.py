"""The readers of the program's own spans and counters
(``repro_torch.tracing``): queue wait, a decode tick's launch and MoE
dispatch, the decode MoE's slot fill and the device's idle time inside
launch spans; and ``idle_by_span.py``'s table of the idle time by
span.  Each reads the run's window alone, a stall inside its span moves
it, and it reads nothing where there is nothing whole to read."""
import sys
import time
import types

import pytest

import cases
from portbench import harness as H
from repro_torch import tracing

PROGRAM = ["queue_wait_p95_ms", "tick_launch_ms", "moe_launch_ms",
           "moe_slot_fill", "idle_launch_share"]
#: the decode MoE of the granite cells: slots, experts, top-k, capacity;
#: and the slots a tick of the synthetic window runs that hold a request
B, E, K, CAP = 64, 32, 8, 8
ACTIVE = 48
T0 = 10.0


class _Log:
    """Records laid out by hand on a clock of their own."""

    def __init__(self):
        self.spans, self.counts, self.sid = [], [], 0

    def span(self, name, t0, t1, parent=None, rid=None):
        self.sid += 1
        s = tracing.Span(name, t0, t1, self.sid,
                         parent.sid if parent else None,
                         rid if rid is not None or parent is None
                         else parent.rid)
        self.spans.append(s)
        return s

    def count(self, name, value, inside):
        """The counter's total in ``inside``, recorded at its close."""
        self.counts.append(tracing.Count(name, value, inside.t1, inside.sid))


def _window(log, stall=None, start=T0):
    """Three cloud requests and one edge-settled from ``start``, then
    five decode ticks of 10 ms (4 ms enqueueing, two MoE layers of 1 ms
    in it, ``ACTIVE`` of ``B`` slots held); ``stall`` adds 0.5 s inside
    one stretch: "queue" (the last request's wait before its admission),
    "tick.launch" (outside its MoE layers) or "moe".  Returns the
    traced device records: each tick's kernels run from 2 ms before its
    launch ends to its end, each admission's through it."""
    add = {k: 0.5 if stall == k else 0.0 for k in
           ("queue", "tick.launch", "moe")}
    kernels, t = [], start
    for rid in range(4):
        e = log.span("edge", t, t + 0.005, rid=rid)
        log.span("edge.launch", t, t + 0.003, e)
        log.span("edge.readback", t + 0.003, t + 0.005, e)
        kernels.append(("edge", t + 0.001, 0.004))
        t += 0.005
    for rid in (1, 2, 3):
        t += add["queue"] if rid == 3 else 0.0
        a = log.span("admit", t, t + 0.02, rid=rid)
        log.span("admit.prefill", t, t + 0.01, a)
        log.span("admit.first_token", t + 0.01, t + 0.015, a)
        log.span("admit.slot_copy", t + 0.015, t + 0.02, a)
        kernels.append(("prefill", t + 0.002, 0.018))
        t += 0.02
    for k in range(5):
        moe_extra = add["moe"] if k == 2 else 0.0
        extra = moe_extra + (add["tick.launch"] if k == 2 else 0.0)
        tick = log.span("tick", t, t + 0.010 + extra)
        launch = log.span("tick.launch", t, t + 0.004 + extra, tick)
        m0 = t + 0.001
        for layer in range(2):
            d = 0.001 + (moe_extra if layer == 0 else 0.0)
            log.span("moe", m0, m0 + d, launch)
            m0 += d
        log.count("moe.slots", 2 * B * E * CAP, launch)
        log.span("tick.readback", t + 0.004 + extra, t + 0.008 + extra,
                 tick)
        log.span("tick.bookkeeping", t + 0.008 + extra, t + 0.010 + extra,
                 tick)
        log.count("tick.active", ACTIVE, tick)
        kernels.append(("decode", t + 0.002 + extra, 0.008))
        t += 0.010 + extra
    return kernels, t


def _warm_up(log):
    """Set-up's spans: a warm-up request (negative id) and a tick before
    the window, and a stray negative id inside it, each far off."""
    log.span("edge", 1.0, 1.5, rid=-1)
    a = log.span("admit", 9.0, 9.5, rid=-1)
    log.span("admit.prefill", 9.0, 9.4, a)
    tick = log.span("tick", 9.5, 9.9)
    launch = log.span("tick.launch", 9.5, 9.8, tick)
    log.span("moe", 9.5, 9.8, launch)
    log.count("moe.slots", 1, launch)
    log.count("tick.active", 1, tick)
    log.span("edge", T0 + 0.001, T0 + 0.002, rid=-2)
    log.span("admit", T0 + 5.0, T0 + 5.1, rid=-2)


def _run(stall=None, warm_up=False, trace=True, evicted=(0, float("-inf")),
         monkeypatch=None):
    log = _Log()
    if warm_up:
        _warm_up(log)
    kernels, t_end = _window(log, stall)
    snap = tracing.Snapshot(list(log.spans), list(log.counts), *evicted)
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    reqs = {rid: {"t_submit": T0, "route": "cloud" if rid else
                  "edge_accept"} for rid in range(4)}
    tr = None
    if trace:
        tr = {"t0": T0, "t1": t_end, "window_s": t_end - T0,
              "busy_s": 0.0, "kernels": kernels}
    return types.SimpleNamespace(requests=reqs, trace=tr, steps=[],
                                 window_s=t_end - T0, model={"top_k": K})


def _read(name, run):
    return H.reader(name).read(run)


@pytest.mark.parametrize("name,stall", [
    ("queue_wait_p95_ms", "queue"), ("tick_launch_ms", "tick.launch"),
    ("tick_launch_ms", "moe"), ("moe_launch_ms", "moe"),
    ("idle_launch_share", "tick.launch")])
def test_a_stall_inside_the_span_moves_the_metric(name, stall, monkeypatch):
    calm = _read(name, _run(monkeypatch=monkeypatch))
    stalled = _read(name, _run(stall, monkeypatch=monkeypatch))
    assert calm is not None and stalled > calm * 1.5


def test_a_stall_outside_the_span_leaves_it(monkeypatch):
    calm = _read("moe_launch_ms", _run(monkeypatch=monkeypatch))
    assert _read("moe_launch_ms", _run("tick.launch",
                                       monkeypatch=monkeypatch)) == calm


def test_the_readings_of_the_calm_window(monkeypatch):
    run = _run(monkeypatch=monkeypatch)
    from portbench.stats import percentile
    waits = [(0.015 * rid - 0.005) * 1e3 for rid in (1, 2, 3)]
    assert _read("queue_wait_p95_ms", run) == pytest.approx(
        percentile(waits, 95))
    assert _read("tick_launch_ms", run) == pytest.approx(4.0)
    assert _read("moe_launch_ms", run) == pytest.approx(2.0)
    assert _read("moe_slot_fill", run) == pytest.approx(
        100 * ACTIVE * K / (B * E * CAP))
    assert _read("moe_slot_fill", run) == 3.125 * ACTIVE / B
    # idle inside launch spans: 1 ms of each edge launch, 2 of each
    # prefill, 2 of each tick's 4 ms launch
    idle = 4 * 0.001 + 3 * 0.002 + 5 * 0.002
    assert _read("idle_launch_share", run) == pytest.approx(
        100 * idle / run.trace["window_s"])


@pytest.mark.parametrize("name,scale", [("moe.slots", 2.0),
                                        ("tick.active", 0.5)])
def test_slot_fill_follows_the_counts(name, scale, monkeypatch):
    """Twice the expert rows run, or half the slots held, halves it."""
    run = _run(monkeypatch=monkeypatch)
    calm = _read("moe_slot_fill", run)
    snap = tracing.snapshot()
    scaled = [c._replace(value=int(scale * c.value)) if c.name == name
              else c for c in snap.counts]
    monkeypatch.setattr(tracing, "snapshot",
                        lambda: snap._replace(counts=scaled))
    assert _read("moe_slot_fill", run) == pytest.approx(calm / 2)


@pytest.mark.parametrize("name", PROGRAM)
def test_nothing_to_read_reads_none(name, monkeypatch):
    run = _run(monkeypatch=monkeypatch)
    assert _read(name, run) is not None
    empty = tracing.Snapshot([], [], 0, float("-inf"))
    monkeypatch.setattr(tracing, "snapshot", lambda: empty)
    assert _read(name, run) is None
    # a program without the recorder: the import fails
    _run(monkeypatch=monkeypatch)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "tracing")
    assert _read(name, run) is None


def test_idle_launch_share_reads_none_without_a_trace(monkeypatch):
    assert _read("idle_launch_share",
                 _run(trace=False, monkeypatch=monkeypatch)) is None
    for name in PROGRAM[:4]:
        assert _read(name, _run(trace=False, monkeypatch=monkeypatch)) \
            is not None


@pytest.mark.parametrize("name", PROGRAM)
def test_warm_up_is_left_out(name, monkeypatch):
    calm = _read(name, _run(monkeypatch=monkeypatch))
    assert _read(name, _run(warm_up=True, monkeypatch=monkeypatch)) == \
        pytest.approx(calm)


@pytest.mark.parametrize("name", PROGRAM)
def test_an_eviction_inside_the_window_reads_none(name, monkeypatch):
    calm = _read(name, _run(monkeypatch=monkeypatch))
    before = _read(name, _run(evicted=(3, T0 - 0.5),
                              monkeypatch=monkeypatch))
    assert before == pytest.approx(calm)
    assert _read(name, _run(evicted=(3, T0 + 0.001),
                            monkeypatch=monkeypatch)) is None


def test_idle_inside_overlapping_launch_spans_counts_once(monkeypatch):
    """Launch spans that overlap (two threads enqueueing at once) hold an
    idle stretch once."""
    run = _run(monkeypatch=monkeypatch)
    calm = _read("idle_launch_share", run)
    snap = tracing.snapshot()
    twins = [s._replace(sid=10_000 + s.sid, t0=s.t0 - 0.0005)
             for s in snap.spans if s.name in tracing.LAUNCH]
    monkeypatch.setattr(tracing, "snapshot",
                        lambda: snap._replace(spans=snap.spans + twins))
    wider = _read("idle_launch_share", run)
    assert calm < wider < calm * 1.5


def test_the_entries_read_the_program():
    got = {m["name"]: m for m in cases.BENCH["per_layer"]
           if m["name"] in PROGRAM}
    every = ["qwen05-doc", "granite-moe-chat", "granite-moe-doc"]
    want = {"queue_wait_p95_ms": ("ms", "lower", "program_span",
                                  "admission", "ttft_p95_ms", every),
            "tick_launch_ms": ("ms", "lower", "program_span",
                               "model step, decode", "tokens_per_s", every),
            "moe_launch_ms": ("ms", "lower", "program_span",
                              "model step, decode", "tokens_per_s",
                              every[1:]),
            "moe_slot_fill": ("%", "higher", "program_counter",
                              "model step, decode", "tokens_per_s",
                              every[1:]),
            "idle_launch_share": ("%", "lower", "device_trace", "device",
                                  "tokens_per_s", every)}
    assert {k: (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"], m["workloads"]) for k, m in got.items()} == want
    assert [m["name"] for m in cases.BENCH["per_layer"][-5:]] == PROGRAM


@pytest.mark.parametrize("config", ["qwen1.5-0.5b", "granite-moe-1b-a400m"])
def test_a_tiny_run_reads_the_program(config):
    """A tiny cell on the CPU through its driver: the program's own
    readers read its window (no trace on the CPU: no idle share)."""
    import torch
    cell = cases.cell(config)
    o = H.driver(cell.mix).run(cell, 7, 0.1, False, torch.device("cpu"),
                               time.perf_counter())
    got = {n: _read(n, o.run) for n in PROGRAM}
    assert got["idle_launch_share"] is None
    assert got["queue_wait_p95_ms"] > 0 and got["tick_launch_ms"] > 0
    tick_ms = sum(b - a for a, b, _, _ in o.run.steps) / len(o.run.steps)
    assert got["tick_launch_ms"] <= tick_ms * 1e3
    ttft = _read("ttft_p95_ms", o.run)
    assert got["queue_wait_p95_ms"] < ttft
    m = cell.config["model"]
    if m.get("num_experts"):
        assert 0 < got["moe_launch_ms"] <= got["tick_launch_ms"]
        # the slots held, as the benchmark's own ``Tap`` saw them
        held = (sum(a for _, _, a, _ in o.run.steps)
                / sum(n for _, _, _, n in o.run.steps))
        assert 0 < held < 1
        assert got["moe_slot_fill"] == pytest.approx(
            100 * m["top_k"] / (m["num_experts"] * 8) * held)
    else:
        assert got["moe_launch_ms"] is None and got["moe_slot_fill"] is None


def _table(run):
    from portbench import idle_by_span
    t = idle_by_span.table(run)
    return t, dict(t["idle_by_span"])


def test_idle_by_span_puts_each_idle_stretch_down_to_its_span(monkeypatch):
    """The calm window's idle time: 1 ms of each edge launch, 2 ms of
    each prefill, and of each tick 1 ms in its launch and 1 ms in its
    first MoE layer; nothing outside the spans."""
    t, rows = _table(_run(monkeypatch=monkeypatch))
    assert t["idle_s"] == pytest.approx(0.020)
    assert sum(rows.values()) == pytest.approx(t["idle_s"])
    want = {"edge > edge.launch": 0.004, "admit > admit.prefill": 0.006,
            "tick > tick.launch": 0.005, "tick > tick.launch > moe": 0.005}
    assert {k: v for k, v in rows.items() if v > 1e-12} == pytest.approx(
        want)
    assert list(rows)[-1] == "outside any span"
    assert t["window_s"] == pytest.approx(t["idle_s"] + 4 * 0.004
                                          + 3 * 0.018 + 5 * 0.008)


@pytest.mark.parametrize("stall,span", [
    ("tick.launch", "tick > tick.launch"),
    ("moe", "tick > tick.launch > moe"),
    ("queue", "outside any span")])
def test_idle_by_span_follows_a_stall(stall, span, monkeypatch):
    _, calm = _table(_run(monkeypatch=monkeypatch))
    _, stalled = _table(_run(stall, monkeypatch=monkeypatch))
    assert stalled[span] > calm[span] + 0.49
    assert sum(stalled.values()) == pytest.approx(sum(calm.values()) + 0.5)


def test_idle_by_span_keeps_the_window_and_needs_a_trace(monkeypatch):
    _, calm = _table(_run(monkeypatch=monkeypatch))
    _, warm = _table(_run(warm_up=True, monkeypatch=monkeypatch))
    assert warm == pytest.approx(calm)
    from portbench import idle_by_span
    assert idle_by_span.table(_run(trace=False,
                                   monkeypatch=monkeypatch)) is None
    run = _run(monkeypatch=monkeypatch)
    empty = tracing.Snapshot([], [], 0, float("-inf"))
    monkeypatch.setattr(tracing, "snapshot", lambda: empty)
    assert idle_by_span.table(run) is None


def test_idle_by_span_without_a_card_prints_no_table(capsys):
    """No card: ``run.py``'s exit 2 and no result, and the harness's
    drivers are its own again."""
    if H.card_count():
        pytest.skip("a card is present")
    from portbench import idle_by_span
    driver = H.driver
    assert idle_by_span.main(["--workload", "qwen05-doc", "--seed", "1",
                              "--seconds", "1"]) == 2
    assert H.driver is driver
    assert capsys.readouterr().out == ""
