"""The port's flight recorder: spans and counters inside the program,
kept in memory for the life of the process.

One recorder serves the whole process (``RECORDER``); the serving path
(``serving/engine.py``) and the model's layers (``models/layers.py``)
both write to it, so it sits at the package's top level.

* A span is a named stretch of host time: ``Span(name, t0, t1, sid,
  parent, rid)``.  ``span(name, rid)`` opens one as a context manager;
  its parent is the span open innermost on the same thread when it
  opened (a stack of open spans), and it takes its parent's request id
  where it is given none, so the spans of one request share ``rid``.
* ``leaf(name, t0)`` records a span that holds no other from a
  ``perf_counter()`` reading to now: one call, for a span opened many
  times a tick (``moe``), where a ``with`` block costs three.
* A counter is a named integer: ``count(name, value)`` adds to the
  counter of the span open innermost on the thread, and the span's close
  records each of its counters once, ``Count(name, total, t1, sid)``
  (outside any span, at once with ``sid`` None).
* Every time is ``time.perf_counter()``, the host clock the benchmark's
  profiler slice is tied to through its ``spin_kernel`` marker
  (``portbench/devtrace.py``), so each span lines up with the device's
  records.

Recording never touches the device: no tensor, no operator, no readback,
no synchronisation; every number kept is known on the host.

The spans of the serving path (``serving/engine.py``, ``models/layers.py``):

=====================  ======================================================
``edge``               ``CascadeServer.submit``'s triage (request id)
``edge.launch``        the edge's forward, classifier and confidence enqueued
``edge.readback``      the confidence read back (waits for the card)
``admit``              ``DecodeEngine.admit`` into a free slot (request id)
``admit.prefill``      the batch-1 prefill enqueued
``admit.first_token``  the first token's argmax read back
``admit.slot_copy``    the prefill cache and first token copied to the slot
``tick``               ``DecodeEngine.step``: one decode tick of every slot
``tick.launch``        the decode step and its argmax enqueued
``tick.readback``      the tokens read back
``tick.bookkeeping``   the slots' host bookkeeping and releases
``moe``                one ``layers.moe_apply`` call, under the launch span
                       open around it
=====================  ======================================================

``LAUNCH`` names the launch spans, in which the host enqueues work for
the card; the benchmark's ``idle_launch_share`` puts the card's idle
time down to the spans of these names.  The wait spans,
``edge.readback``, ``admit.first_token`` and ``tick.readback``, are
those in which the host waits for the card to read a value back.  A
request waits in the server's queue from the end of its ``edge`` span to
the start of its ``admit`` span.  ``portbench/idle_by_span.py`` puts the
card's idle time down to every span here.

Counters: ``tick.active``, the slots a decode tick ran that held a
request (on ``tick``), and ``moe.slots``, the expert rows the grouped
product of each ``moe_apply`` call of one token a row runs
(B*E*capacity, the shape of its expert buffers), summed into the span
open around the call: a decode tick's ``tick.launch`` holds its layers'
sum.

Memory is bounded: one buffer of ``CAPACITY`` records, spans and counts
together; past it the oldest record is evicted, and ``snapshot`` says how
many were and the latest time among them.  Reckoned for the benchmark's
largest cell (granite-moe-1b-a400m under chat bursts, 24 MoE layers): a
decode tick records 4 spans, 24 ``moe`` spans and 2 counts (30), an
admission 4 spans and 24 ``moe`` spans (28), an edge triage 5 (its edge
model's two MoE layers), so a burst of 128 requests (96 to the cloud,
~134 ticks on an H100) ~7,400, and set-up ~4,000.  A 40 s window and the burst in flight hold at most four
such bursts, ~30,000 records: under a sixteenth of ``CAPACITY``, which
holds such a window at ticks down to ~5 ms.  A record takes ~150 bytes
of host memory, so a full buffer ~80 MB.

``ENABLED`` is the switch, on by default, so a running server keeps this
record; set it False and ``span`` hands back one shared no-op, and
``leaf`` and ``count`` return at once.  ``snapshot()`` returns plain lists, for
tests and the benchmark's readers.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import math
import threading
from time import perf_counter
from typing import Dict, List, NamedTuple, Optional

#: the switch: False and recording costs one test a call
ENABLED = True
#: records (spans and counts) the buffer holds before it evicts the oldest
CAPACITY = 1 << 19
#: the launch spans: the host is enqueueing work for the card
LAUNCH = ("edge.launch", "admit.prefill", "admit.slot_copy", "tick.launch")


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    sid: int
    parent: Optional[int]
    rid: Optional[int]


class Count(NamedTuple):
    name: str
    value: int
    t: float
    sid: Optional[int]


class Snapshot(NamedTuple):
    spans: List[Span]
    counts: List[Count]
    evicted: int           # records evicted since the recorder began
    evicted_until: float   # the latest end time among them (-inf: none)


class _Stack(threading.local):
    def __init__(self) -> None:
        # (name, t0, sid, parent, rid) of the open spans, innermost last
        self.open: List[tuple] = []
        # sid -> the counters added inside that open span, by name
        self.counts: Dict[int, Dict[str, int]] = {}


class Recorder:
    """A bounded buffer of span and count records, and the open spans of
    each thread."""

    def __init__(self, capacity: int = CAPACITY) -> None:
        if capacity < 1:
            raise ValueError(f"capacity {capacity} must be at least 1")
        self.capacity = capacity
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._stack = _Stack()
        self.recorded = 0
        self.evicted_until = -math.inf

    def _put(self, rec: tuple) -> None:
        # rec[2] is a span's end or a count's time; acquire and release
        # cost a third of a ``with`` block
        self._lock.acquire()
        try:
            if len(self._buf) == self.capacity:
                self.evicted_until = max(self.evicted_until, self._buf[0][2])
            self._buf.append(rec)
            self.recorded += 1
        finally:
            self._lock.release()

    def count(self, name: str, value: int) -> None:
        """Add to the counter ``name`` of the span open innermost on this
        thread (recorded when it closes), or record it now outside any."""
        st = self._stack
        if not st.open:
            self._put((name, value, perf_counter(), None))
            return
        sid = st.open[-1][2]
        counts = st.counts.get(sid)
        if counts is None:
            st.counts[sid] = {name: value}
        else:
            counts[name] = counts.get(name, 0) + value

    def open(self, name: str, rid: Optional[int]) -> None:
        """Open the span ``name`` on this thread's stack: its parent the
        span open innermost, whose request id it takes where it is given
        none."""
        open_ = self._stack.open
        if open_:
            _, _, parent, _, parent_rid = open_[-1]
            if rid is None:
                rid = parent_rid
        else:
            parent = None
        open_.append((name, perf_counter(), next(self._ids), parent, rid))

    def leaf(self, name: str, t0: float) -> None:
        """Record the span ``name`` from ``t0`` to now, under the span
        open innermost on this thread and with its request id."""
        open_ = self._stack.open
        parent, rid = (open_[-1][2], open_[-1][4]) if open_ else (None, None)
        self._put((name, t0, perf_counter(), next(self._ids), parent, rid))

    def close(self) -> None:
        """Record the span open innermost on this thread, then each
        counter added inside it."""
        t1 = perf_counter()
        st = self._stack
        name, t0, sid, parent, rid = st.open.pop()
        self._put((name, t0, t1, sid, parent, rid))
        if st.counts:
            for counter, value in st.counts.pop(sid, {}).items():
                self._put((counter, value, t1, sid))

    def snapshot(self) -> Snapshot:
        with self._lock:
            recs = list(self._buf)
            evicted = self.recorded - len(recs)
            until = self.evicted_until
        return Snapshot([Span(*r) for r in recs if len(r) == 6],
                        [Count(*r) for r in recs if len(r) == 4],
                        evicted, until)


class _Span:
    """The context manager of the spans of one name (and request id):
    an open span lives on its thread's stack, so one object serves every
    span of its name, nested or on several threads."""
    __slots__ = ("name", "rid")

    def __init__(self, name: str, rid: Optional[int]):
        self.name, self.rid = name, rid

    def __enter__(self) -> "_Span":
        RECORDER.open(self.name, self.rid)
        return self

    def __exit__(self, *exc) -> bool:
        RECORDER.close()
        return False


_NOOP = contextlib.nullcontext()
#: the process's recorder; swap it only while no span is open
RECORDER = Recorder()
#: the shared ``_Span`` of each name opened without a request id
_SPANS: Dict[str, _Span] = {}


def span(name: str, rid: Optional[int] = None):
    """A context manager recording the span ``name`` (request ``rid``,
    else its parent's) under the span open innermost on this thread."""
    if not ENABLED:
        return _NOOP
    if rid is not None:
        return _Span(name, rid)
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = _Span(name, None)
    return s


def leaf(name: str, t0: float) -> None:
    """Record the span ``name`` from ``t0``, a ``perf_counter()`` reading,
    to now, under the span open innermost on this thread: a span that
    holds no other, in one call where ``span`` takes three."""
    if ENABLED:
        RECORDER.leaf(name, t0)


def count(name: str, value: int) -> None:
    """Add ``value`` to the counter ``name`` of the span open innermost on
    this thread; one record a counter and span, when the span closes."""
    if ENABLED:
        RECORDER.count(name, value)


def snapshot() -> Snapshot:
    """Every record the buffer holds, oldest first, and what it evicted."""
    return RECORDER.snapshot()
