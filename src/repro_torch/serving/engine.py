"""Slot-based continuous-batching decode engine with a cascade front-end,
and the real-time driver for the simulation pipeline.

The serving path for the LLMs: a fixed-size decode batch ("slots")
runs one ``decode_step`` per tick; finished or empty slots are refilled
from the request queue (a batch-1 prefill on admission), so the big model
never idles while requests trickle in — the LLM-serving analogue of the
paper's "keep the cloud busy with exactly the work the edge couldn't
settle".  Requests enter through the SurveilEdge triage: the edge CQ
model scores each prompt, confident ones are answered at the edge, the
rest are admitted to the cloud decode batch.  Under the cloud config's
``attn_impl="flash"`` every admission's prefill runs the flash-attention
kernel once a layer; decode (one query token) stays on the chunked path,
as in the reference.  Every family whose prefill takes tokens alone
serves here (dense, MoE, SSM, hybrid); like the reference's, the engine
passes no ``audio_frames`` or ``img_embeds``, so whisper and internvl2
run through ``transformer.prefill``/``decode_step`` directly.

Both classes take an explicit ``device``: the card by default, which
raises ``RuntimeError`` on a host without one; ``device="cpu"`` runs
every kernel's plain version.

For the simulation pipeline, ``QueryPipeline`` exposes a seam (setup /
handle_event / finalize); ``SimDriver`` (system/pipeline.py) drains the
event heap at zero wall-clock cost.  ``AsyncDriver`` pumps the SAME heap from asyncio
against a Clock, which is what turns the simulator into a serving
process: in wall time, events fire when their simulated instant
actually arrives; in virtual time, the clock just jumps — bit-identical
pops to SimDriver, so every control-plane feature can be tested
deterministically and then served unchanged.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import heapq
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import cascade as C
from repro_torch.core.speculative import greedy
from repro_torch.core.thresholds import ThresholdState
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray                  # (S,) prompt
    max_new: int = 16
    # filled by the engine:
    output: Optional[np.ndarray] = None
    route: str = "pending"              # edge_accept | edge_reject | cloud
    ticks_waited: int = 0


@dataclasses.dataclass
class SlotState:
    rid: int = -1
    remaining: int = 0
    generated: Optional[List[int]] = None

    @property
    def free(self) -> bool:
        return self.rid < 0


def _on(dev: torch.device, params):
    return M.tree_map(lambda t: torch.as_tensor(t).to(dev), params)


class DecodeEngine:
    """Continuous batching over a fixed slot count for ONE model on
    ``device``.  The engine's cache is updated in place."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int,
                 cache_len: int, window: Optional[int] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _on(self.device, params)
        self.slots = [SlotState() for _ in range(slots)]
        self.cache_len = cache_len
        self.window = window
        self.cache = T.make_cache(cfg, slots, cache_len, dtype=torch.float32,
                                  device=self.device)
        self.tokens = torch.zeros((slots,), dtype=torch.int32,
                                  device=self.device)
        self.ticks = 0

    # ---- slot management -----------------------------------------------------
    @torch.no_grad()
    def admit(self, req: Request) -> bool:
        """Prefill the request into a free slot; False if the batch is full."""
        for i, slot in enumerate(self.slots):
            if slot.free:
                with tracing.span("admit", req.rid):
                    with tracing.span("admit.prefill"):
                        prompt = torch.as_tensor(np.asarray(req.tokens),
                                                 dtype=torch.long,
                                                 device=self.device)[None]
                        logits, cache1 = T.prefill(
                            self.cfg, self.params, prompt,
                            cache_len=self.cache_len, window=self.window)
                    with tracing.span("admit.first_token"):
                        first = int(greedy(logits[0]))
                    with tracing.span("admit.slot_copy"):
                        self._write_slot_cache(i, cache1)
                        self.tokens[i] = first
                    self.slots[i] = SlotState(rid=req.rid,
                                              remaining=req.max_new - 1,
                                              generated=[first])
                return True
        return False

    def _write_slot_cache(self, i: int, cache1) -> None:
        """Copy a batch-1 prefill cache into slot i of the engine cache.

        Positions are per-sequence ((B,)/(B,W)), so slots at different
        prefix lengths coexist — true mid-flight continuous batching."""
        M.tree_map(lambda dst, src: dst[:, i:i + 1].copy_(src),
                   self.cache["layers"], cache1["layers"])
        self.cache["pos"][i] = cache1["pos"][0]
        # pad the batch-1 kpos up to the engine cache length
        kp = cache1["kpos"][0]
        if kp.shape[0] < self.cache_len:
            kp = torch.cat([kp, torch.full((self.cache_len - kp.shape[0],),
                                           -1, dtype=torch.int32,
                                           device=kp.device)])
        self.cache["kpos"][i] = kp

    def _release_slot(self, i: int) -> None:
        """Reset a freed slot's bookkeeping so its lane stays benign."""
        self.cache["pos"][i] = 0
        self.cache["kpos"][i] = -1

    @torch.no_grad()
    def step(self) -> List[Tuple[int, List[int]]]:
        """One decode tick for every active slot.  Returns finished
        (rid, generated_tokens) pairs."""
        self.ticks += 1
        with tracing.span("tick"):
            with tracing.span("tick.launch"):
                logits, self.cache = T.decode_step(
                    self.cfg, self.params, self.cache, self.tokens,
                    window=self.window)
                self.tokens = greedy(logits)
            with tracing.span("tick.readback"):
                nxt = self.tokens.tolist()
            with tracing.span("tick.bookkeeping"):
                done, rows = [], 0
                for i, slot in enumerate(self.slots):
                    if slot.free:
                        continue
                    rows += 1
                    slot.generated.append(nxt[i])
                    slot.remaining -= 1
                    if slot.remaining <= 0:
                        done.append((slot.rid, list(slot.generated)))
                        self.slots[i] = SlotState()
                        self._release_slot(i)
            tracing.count("tick.active", rows)
        return done

    @property
    def active(self) -> int:
        return sum(not s.free for s in self.slots)


class CascadeServer:
    """Edge triage + cloud continuous-batching decode, both on ``device``."""

    def __init__(self, edge_cfg: ModelConfig, edge_params,
                 cloud_cfg: ModelConfig, cloud_params, *,
                 slots: int = 4, cache_len: int = 128,
                 thresholds: Optional[ThresholdState] = None,
                 device="cuda"):
        self.edge_cfg = edge_cfg
        self.device = resolve_device(device)
        self.edge_params = _on(self.device, edge_params)
        self.th = thresholds or ThresholdState(alpha=0.8, beta=0.1)
        self.engine = DecodeEngine(cloud_cfg, cloud_params, slots=slots,
                                   cache_len=cache_len, device=self.device)
        # deque: admission pops from the head every tick, and a long
        # backlog under a full batch made list.pop(0) O(n) per admit —
        # O(n^2) across a rush
        self.queue: Deque[Request] = collections.deque()
        self.results: Dict[int, Request] = {}

    @torch.no_grad()
    def edge_conf(self, tokens) -> float:
        """The edge CQ model's P(query object) for one (S,) prompt."""
        with tracing.span("edge.launch"):
            t = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                device=self.device)[None]
            h, _ = T.forward(self.edge_cfg, self.edge_params, t)
            conf = C.confidence_from_logits(
                T.classify(self.edge_cfg, self.edge_params, h))[0]
        with tracing.span("edge.readback"):
            return float(conf)

    def submit(self, req: Request) -> None:
        with tracing.span("edge", req.rid):
            conf = self.edge_conf(req.tokens)
        route = self.th.triage(conf)
        if route == "accept":
            req.route, req.output = "edge_accept", np.asarray([1])
            self.results[req.rid] = req
        elif route == "reject":
            req.route, req.output = "edge_reject", np.asarray([0])
            self.results[req.rid] = req
        else:
            req.route = "cloud"
            self.queue.append(req)

    def run(self, requests: List[Request], max_ticks: int = 1000
            ) -> Dict[int, Request]:
        pending: Dict[int, Request] = {}
        for r in requests:
            self.submit(r)
            if r.route == "cloud":
                pending[r.rid] = r
        # Mid-flight continuous batching: positions are per-sequence, so any
        # freed slot is refilled immediately, regardless of how far the other
        # slots have decoded or how long the new prompt is.
        ticks = 0
        while (self.queue or self.engine.active) and ticks < max_ticks:
            while self.queue and self.engine.admit(self.queue[0]):
                self.queue.popleft()
            for req in self.queue:
                req.ticks_waited += 1
            if self.engine.active:
                for rid, generated in self.engine.step():
                    req = pending.pop(rid)
                    req.output = np.asarray(generated, np.int32)
                    self.results[rid] = req
            ticks += 1
        return self.results


# --- real-time driver for the simulation pipeline -----------------------------


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
