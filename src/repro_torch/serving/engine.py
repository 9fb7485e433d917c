"""Real-time driver for the simulation pipeline.

``QueryPipeline`` exposes a driver seam (setup / handle_event /
finalize); ``SimDriver`` (system/pipeline.py) drains the event heap at
zero wall-clock cost.  ``AsyncDriver`` pumps the SAME heap from asyncio
against a Clock, which is what turns the simulator into a serving
process: in wall time, events fire when their simulated instant
actually arrives; in virtual time, the clock just jumps — bit-identical
pops to SimDriver, so every control-plane feature can be tested
deterministically and then served unchanged.

The reference package's ``serving/engine.py`` also holds the LLM decode
engine and cascade server; they come with the port's LLM slice.
"""
from __future__ import annotations

import asyncio
import heapq
import time
from typing import Any, Callable, List, Optional, Tuple


class VirtualClock:
    """Deterministic clock: ``sleep_until`` jumps straight to ``t``.

    The single ``asyncio.sleep(0)`` yield keeps the pump cooperative (a
    co-scheduled submitter coroutine gets a turn per event) without ever
    consulting real time."""

    def __init__(self) -> None:
        self._t = 0.0

    def now(self) -> float:
        return self._t

    async def sleep_until(self, t: float) -> None:
        if t > self._t:
            self._t = t
        await asyncio.sleep(0)


class WallClock:
    """Real time, scaled: ``speed`` simulated seconds pass per wall
    second (speed=60 replays a minute of fleet per wall second)."""

    def __init__(self, speed: float = 1.0) -> None:
        if speed <= 0:
            raise ValueError(f"speed={speed} must be > 0")
        self.speed = speed
        self._t0: Optional[float] = None

    def _origin(self) -> float:
        if self._t0 is None:
            self._t0 = time.monotonic()
        return self._t0

    def now(self) -> float:
        return (time.monotonic() - self._origin()) * self.speed

    async def sleep_until(self, t: float) -> None:
        delay = (t - self.now()) / self.speed
        if delay > 0:
            await asyncio.sleep(delay)


class AsyncDriver:
    """Pump a ``QueryPipeline``'s event heap from an asyncio loop.

    ``call_at(t, fn)`` schedules a host hook at simulated time ``t`` —
    the live-submission entry point (``QueryAPI.submit`` from a hook
    pushes ``QueryArrival`` into the same heap).  Hooks run strictly
    BEFORE simulation events at the same instant, so a submission at t
    is admitted by the arrival it just pushed, never raced by it.

    With no hooks, the pump peeks the heap, sleeps the clock to the
    event's instant, and pops — exactly ``SimDriver``'s order (same
    heap, same tie-breaking seq), which the differential tests assert
    bit-identical.
    """

    def __init__(self, clock: Optional[object] = None) -> None:
        self.clock = clock or VirtualClock()
        self._hooks: List[Tuple[float, int, Callable[[float], Any]]] = []
        self._hseq = 0
        self.events_pumped = 0
        self.hooks_run = 0

    def call_at(self, t: float, fn: Callable[[float], Any]) -> None:
        """Run ``fn(t)`` at simulated time ``t`` (FIFO among equal t)."""
        self._hseq += 1
        heapq.heappush(self._hooks, (t, self._hseq, fn))

    def drive(self, pipe) -> None:
        """Synchronous entry point for ``QueryPipeline.run``."""
        asyncio.run(self.pump(pipe))

    async def pump(self, pipe) -> None:
        """The async loop proper — await this directly (e.g. gathered
        with a live submitter coroutine) when the caller already owns an
        event loop."""
        while True:
            ev_t = pipe.events.peek_time()
            hook_t = self._hooks[0][0] if self._hooks else None
            if ev_t is None and hook_t is None:
                return
            nxt = min(x for x in (ev_t, hook_t) if x is not None)
            await self.clock.sleep_until(nxt)
            # re-peek: a wall-clock sleep (or the virtual clock's yield)
            # may have let a co-scheduled coroutine push earlier work
            ev_t = pipe.events.peek_time()
            hook_t = self._hooks[0][0] if self._hooks else None
            if hook_t is not None and (ev_t is None or hook_t <= ev_t):
                t, _, fn = heapq.heappop(self._hooks)
                self.hooks_run += 1
                fn(t)
            elif ev_t is not None:
                t, ev = pipe.events.pop()
                self.events_pumped += 1
                pipe.handle_event(t, ev)
