"""The program's own spans and counters (``repro_torch.tracing``) over a
run's window, for the readers under ``metrics/``.

The window is what the run served: the spans of its requests (an id in
``run.requests``) and the spans of no request (decode ticks and what
they hold) that start at or after its first submission; warm-up, with
negative request ids and before the window, is left out.  ``window``
gives None, and so a reader reads nothing, where the program has no
recorder (a program older than it), where the recorder holds nothing of
the window, or where it evicted a record the window could hold: never a
truncated value.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class Window:
    spans: list        # repro_torch.tracing.Span records
    counts: list       # repro_torch.tracing.Count records
    launch: Sequence[str]   # the names of the program's launch spans

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def under(self, parents: list, name: str) -> list:
        """The spans ``name`` whose parent is one of ``parents``."""
        ids = {p.sid for p in parents}
        return [s for s in self.spans if s.name == name and s.parent in ids]

    def counted(self, spans: list, name: str) -> dict:
        """The counter ``name`` of each of ``spans`` that holds it, by
        span id."""
        ids = {s.sid for s in spans}
        return {c.sid: c.value for c in self.counts
                if c.name == name and c.sid in ids}

    def queue_waits(self) -> list:
        """Each admitted request's wait in the server's queue, seconds:
        from the end of its ``edge`` span to the start of its ``admit``
        span."""
        edge = {s.rid: s.t1 for s in self.named("edge")}
        return [s.t0 - edge[s.rid] for s in self.named("admit")
                if s.rid in edge]

    def decode(self) -> Tuple[list, list]:
        """The window's decode ticks and their launch spans."""
        ticks = self.named("tick")
        return ticks, self.under(ticks, "tick.launch")


def window(run) -> Optional[Window]:
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    subs = [r["t_submit"] for r in run.requests.values()]
    if not subs:
        return None
    lo = min(subs)
    snap = tracing.snapshot()
    if snap.evicted and snap.evicted_until >= lo:
        return None
    spans = [s for s in snap.spans if s.t0 >= lo
             and (s.rid is None or s.rid in run.requests)]
    if not spans:
        return None
    return Window(spans, [c for c in snap.counts if c.t >= lo],
                  tracing.LAUNCH)

