"""Slim orchestrator for the end-to-end cloud-edge query engine.

The engine is layered; this module only composes the layers and runs the
event loop:

  frontend   repro_torch.system.frontend   detection stream (the model-free
                                     confidence stream, or the pixel/CNN
                                     path of ``system.pixel_frontend``
                                     behind the same ``Frontend`` seam)
  events     repro_torch.system.events     typed events + time-ordered queue
  queries    repro_torch.system.queries    runtime CQ lifecycle: arrival ->
                                     Fig. 5 cloud fine-tune -> per-edge
                                     weight shipment (WAN downlink) ->
                                     serve -> retire; detections whose
                                     query has no model on their edge yet
                                     wait in a deferral buffer
  triage     repro_torch.system.triage     per-(query, edge) Eqs. 8-9 thresholds
                                     + ONE fused (Q, E, N) triage kernel
                                     launch per scheduler tick
                                     (``ops.triage_fleet``)
  allocator  repro_torch.core.scheduler    Eq. 7: argmin_j Q_j * t_j (+ WAN
                                     backlog for the cloud), node liveness
  nodes      repro_torch.system.nodes      per-node deque queues, service state,
                                     failure bookkeeping
  transport  repro_torch.system.transport  shared-FIFO WAN uplink + downlink,
                                     dedicated LAN links, byte accounting
  feedback   repro_torch.system.feedback   cloud->edge learning loop: cloud
                                     labels -> ONE fused calibrate launch
                                     per update_period_s -> per-edge Platt
                                     params over the WAN downlink
  metrics    repro_torch.system.metrics    QueryReport

Beyond-paper stress is first-class: scenarios may declare traffic bursts
and mid-run edge failures (queued work is re-dispatched, the dead edge's
cameras re-home to survivors via Eq. 7).  Entry point unchanged:
``run_query(scenario) -> QueryReport``.

The event loop itself is a pluggable **driver** behind a three-method
seam — ``setup(items)`` / ``handle_event(t, ev)`` / ``finalize()``:

  SimDriver    (here)                  classic DES: drain the heap in
                                       time order at zero wall-clock cost.
                                       The default; every preset and the
                                       superstep path run on it unchanged.
  AsyncDriver  repro_torch.serving.engine
                                       the same heap pumped from an
                                       asyncio loop against a ``Clock``
                                       (virtual for deterministic tests —
                                       bit-identical pops to SimDriver —
                                       or wall for real-time serving),
                                       with ``call_at`` hooks for live
                                       query submission (serving/api.py).

Every kernel launch of a run goes to one ``device``: the card unless the
caller asks for the CPU, where each kernel wrapper runs its plain PyTorch
version.  ``Scenario.superstep`` fuses boundary-free runs of ticks into
one scan-superstep launch (``system.superstep``); track queries
(``QuerySpec.kind == "track"``) add one fused association launch per tick
(``system.tracks``).

The serving control plane rides on the seam: per-tenant admission
(token-bucket quotas + backlog shedding, ``repro_torch.serving.api``), priority
tiers woven into Eq. 7 as an SLO-pressure cost term, and an alert/health
stream published on the Bus (``alerts/#`` — admission sheds, failovers,
queue depth, threshold drift) that ``QueryReport`` snapshots.  All of it
is opt-in per scenario; the tierless/quota-free defaults are
bit-identical to the pre-control-plane engine.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import CLOUD, Scheduler
from repro_torch.serving.alerts import AlertStream
from repro_torch.serving.api import AdmissionController
from repro_torch.serving.bus import Bus, ParamDB
from repro_torch.serving.simulator import Item
from repro_torch.system import metrics as MX
from repro_torch.kernels.runtime import resolve_device
from repro_torch.system.events import (
    BOUNDARY_EVENTS,
    Arrive,
    EdgeFail,
    EventQueue,
    FeedbackTick,
    ModelUpdate,
    QueryArrival,
    QueryRetire,
    ReleaseTick,
    Sample,
    ServiceDone,
    Task,
    TickArrivals,
    TrainDone,
    Transfer,
)
from repro_torch.system.feedback import FeedbackStage
from repro_torch.system.frontend import ConfidenceStreamFrontend
from repro_torch.system.pixel_frontend import PixelFrontend
from repro_torch.system.nodes import NodeBank
from repro_torch.system.queries import QuerySet, QuerySpec
from repro_torch.system.scenario import Scenario
from repro_torch.system.superstep import Ctrl, SuperstepDriver
from repro_torch.system.tracks import TrackStage
from repro_torch.system.transport import Transport
from repro_torch.system.triage import ACCEPT, ESCALATE, TriageStage


def group_arrivals(items: Sequence[Item], interval_s: float
                   ) -> List[Tuple[int, Dict[int, List[Item]]]]:
    """Group a stream into per-tick, per-edge batches with numpy.

    Returns ``[(tick_index, {edge: [items]}), ...]`` in tick order; within
    each (tick, edge) group arrival order is preserved (stable lexsort over
    an already arrival-sorted stream).  The grouping work is O(n) numpy —
    no per-item Python dict churn, which matters at city scale."""
    if not items:
        return []
    n = len(items)
    arr = np.empty(n, object)
    arr[:] = list(items)
    t = np.fromiter((it.t_arrival for it in items), np.float64, n)
    e = np.fromiter((it.edge_device for it in items), np.int64, n)
    ticks = (t // interval_s).astype(np.int64)
    order = np.lexsort((e, ticks))
    arr, ticks, e = arr[order], ticks[order], e[order]
    out: List[Tuple[int, Dict[int, List[Item]]]] = []
    tick_cuts = np.flatnonzero(np.diff(ticks)) + 1
    for s0, s1 in zip(np.r_[0, tick_cuts], np.r_[tick_cuts, n]):
        seg_e = e[s0:s1]
        edge_cuts = np.flatnonzero(np.diff(seg_e)) + 1
        batches = {
            int(seg_e[b0]): list(arr[s0 + b0:s0 + b1])
            for b0, b1 in zip(np.r_[0, edge_cuts],
                              np.r_[edge_cuts, s1 - s0])}
        out.append((int(ticks[s0]), batches))
    return out


class SimDriver:
    """Classic discrete-event driver: drain the heap in time order.

    Zero wall-clock cost per event; the default for every preset and the
    only driver the superstep path supports.  ``AsyncDriver``
    (``repro_torch.serving.engine``) pumps the same heap from an asyncio
    loop — in virtual time it pops in exactly this order, which is what
    the differential tests assert."""

    def drive(self, pipe: "QueryPipeline") -> None:
        while pipe.events:
            t, ev = pipe.events.pop()
            pipe.handle_event(t, ev)


class QueryPipeline:
    """Event loop over one scenario.  Build once, ``run()`` once.

    ``driver`` plugs the event-loop strategy (default ``SimDriver``); any
    driver calls the same ``setup`` / ``handle_event`` / ``finalize``
    seam, so simulated and real-time runs share every handler.  ``device``
    is where every kernel launch of the run goes: the card (default; raises
    ``RuntimeError`` where torch finds none) unless the caller passes
    ``"cpu"``."""

    def __init__(self, sc: Scenario, driver: Optional[object] = None,
                 device="cuda"):
        self.sc = sc
        self.driver = driver
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(sc.seed + 1)
        # topology: cloud is node 0, edges 1..E (service-time multipliers)
        self.service_s: Dict[int, float] = {
            CLOUD: sc.edge_service_s / sc.cloud_speedup}
        for nid, mult in zip(sc.edge_ids, sc.edge_speeds):
            self.service_s[nid] = sc.edge_service_s * mult
        for t_fail, nid in sc.failures:
            if nid not in self.service_s or nid == CLOUD:
                raise ValueError(
                    f"scenario {sc.name!r}: failure at t={t_fail} references "
                    f"node {nid}, but failable edges are {list(sc.edge_ids)}")
        self.sched = Scheduler(sorted(self.service_s),
                               interval_s=sc.interval_s)
        self.bus = Bus()
        self.db = ParamDB(self.bus)
        for nid, svc in self.service_s.items():
            self.db.put(f"t{nid}", svc)
            self.db.put(f"Q{nid}", 0)
            self.sched.nodes[nid].estimator.t = svc
        # control plane (all opt-in per scenario; absent -> bit-identical
        # to the pre-control-plane engine): priority tiers feed the
        # SLO-pressure Eq. 7 term and per-tier latency accounting; the
        # alert stream snapshots every alerts/# publication for the report
        self._tiers = {ts.tier: ts for ts in sc.tiers}
        self._tier_of: Dict[int, int] = {
            sp.query: sp.tier for sp in sc.queries}
        self.alerts = AlertStream(self.bus)

    # --- event machinery ------------------------------------------------------
    def _enqueue(self, t: float, node: int, task: Task) -> None:
        self.nodes.push(node, task)
        self.sched.on_enqueue(node)
        self.db.put(f"Q{node}", self.sched.nodes[node].queue_len)
        if not self.nodes.busy[node]:
            self._start_service(t, node)

    def _start_service(self, t: float, node: int) -> None:
        task, svc = self.nodes.begin(t, node)
        self.events.push(t + svc, ServiceDone(node, task, svc))

    def _finish(self, t: float, node: int, it: Item, decision: bool,
                serve_t: Optional[float] = None) -> None:
        # serve_t: when the user actually saw the answer.  For speculative
        # escalations that is the provisional serve instant (upload start),
        # not the reconcile instant ``t`` — latency and window placement
        # follow what was served; accuracy follows the reconciled decision.
        ts = t if serve_t is None else serve_t
        if self._tier_acc is not None:
            # per-tier latency/accuracy cells + SLO breach counts (the
            # control plane's acceptance signal: tier 0 must stay at zero
            # breaches while lower tiers absorb the rush)
            k = self._tier_of.get(it.query, 0)
            lat = ts - it.t_arrival
            self._tier_acc[k].add(lat, decision, it.is_query)
            if lat > self._tiers[k].slo_s:
                self._tier_breach[k] += 1
        if self._agg is not None:
            # streaming windowed aggregates (metrics_window_s): O(1) per
            # item, no per-item arrays held for the report
            self._agg.add(ts, ts - it.t_arrival, decision, it.is_query,
                          it.query)
        else:
            self._lat.append(ts - it.t_arrival)
            self._dec.append(decision)
            self._tru.append(it.is_query)
            self._fin.append(ts)
            self._qid.append(it.query)
        self.nodes.served[node] += 1

    def _dispatch(self, t: float, src: int, task: Task,
                  count_escalated: bool, exclude_src: bool = False) -> None:
        """Route one re-classification task via Eq. 7 and ship it.

        ``exclude_src`` is for overload shedding: work shed *because* src
        is drowning must not be allowed to win the argmin and land right
        back on src at the heavier re-classify cost.
        """
        if self.sc.scheme == "surveiledge_fixed":
            target = CLOUD          # local-edge-first: escalations go up
        else:
            extra = {CLOUD: self.transport.wan_backlog(t)}
            if self._tiers:
                # priority tiers: a weighted tier's item adds SLO
                # pressure to Eq. 7 — nodes that would blow its
                # remaining slack are penalized in proportion (weight 0
                # or no tiers leaves the argmin bit-identical)
                tsp = self._tiers.get(
                    self._tier_of.get(task.item.query, 0))
                if tsp is not None and tsp.weight > 0.0:
                    extra = self.sched.slo_pressure(
                        tsp.weight,
                        tsp.slo_s - (t - task.item.t_arrival), extra)
            try:
                # edge_only has no cloud path: its failovers stay on the
                # surviving edges (cloud only as a last resort below)
                target = self.sched.select_node(
                    exclude_cloud=self.sc.scheme == "edge_only",
                    exclude={src} if exclude_src else (),
                    extra_cost=extra)
            except ValueError:
                target = CLOUD      # the cloud never fails in our scenarios
        if count_escalated:
            self._escalated += 1
        nbytes = task.item.nbytes
        if target == src:
            self.events.push(t, Transfer(target, task))
        elif target == CLOUD:
            done = self.transport.wan_send(t, nbytes)
            task.tx_s += done - t
            self.events.push(done, Transfer(target, task))
        else:
            done = self.transport.lan_send(t, nbytes)
            task.tx_s += done - t
            self.events.push(done, Transfer(target, task))

    # --- scan-superstep support -----------------------------------------------
    def _sample_ctrl(self, t: float) -> None:
        """Sample the Eqs. 8-9 / shed control signals for the superstep
        path: the Eq. 7 escalation-target drain (incl. WAN backlog for
        the cloud), every edge's own queue drain, and the overload-shed
        set.  Called at the first triaged tick after each boundary event
        (``_ctrl_dirty``) and held until the next one — the resample
        points are boundary-determined, never K-determined, which is
        what makes any superstep segmentation bit-exact vs. any other."""
        try:
            d = self.sched.select_node(
                extra_cost={CLOUD: self.transport.wan_backlog(t)})
        except ValueError:
            d = CLOUD
        esc_drain = self.sched.nodes[d].drain_time
        if d == CLOUD:
            esc_drain += self.transport.wan_backlog(t)
        edge_drain = {e: self.sched.nodes[e].drain_time
                      for e in self.sc.edge_ids}
        self._ctrl = Ctrl(
            esc_drain=esc_drain, edge_drain=edge_drain,
            overloaded=frozenset(
                e for e, dr in edge_drain.items()
                if dr > self.sc.offload_drain_s))
        self._ctrl_dirty = False

    def _ready_of(self, batches: Dict[int, List[Item]]
                  ) -> Dict[Tuple[int, int], List[Item]]:
        """Pure (side-effect-free) version of ``_on_tick``'s ready
        classification, used by the superstep planner on FUTURE ticks.
        Everything it reads — node liveness, query liveness/retirement —
        only mutates at boundary events, and plans never span one, so
        the plan-time result equals the fold-time result exactly."""
        ready: Dict[Tuple[int, int], List[Item]] = {}
        for edge, batch in batches.items():
            if edge in self.nodes.dead:
                continue
            for it in batch:
                if self.queries.live_on(it.query, edge):
                    ready.setdefault((it.query, edge), []).append(it)
        return ready

    # --- per-tick fused triage ------------------------------------------------
    def _on_tick(self, t: float, batches: Dict[int, List[Item]],
                 tick: int = -1) -> None:
        """One scheduler tick's arrivals: failover dead edges' batches,
        defer queries whose CQ weights haven't reached their edge yet, shed
        overloaded edges' raw batches via Eq. 7, triage everything else —
        every live query on every live edge — in ONE fused (Q, E, N)
        launch, enqueue per-route."""
        if self._release:
            # weights delivered since last tick: the items that were
            # waiting join this tick's batches (ONE launch covers both)
            merged = {e: list(b) for e, b in batches.items()}
            for e, pend in self._release.items():
                merged.setdefault(e, []).extend(pend)
            self._release = {}
            batches = merged
        live: Dict[int, List[Item]] = {}
        for edge, batch in batches.items():
            if edge in self.nodes.dead:
                # dead edge's cameras re-home: raw frames to survivors
                for it in batch:
                    if self.queries.is_shed(it.query):
                        self._shed_items += 1
                        continue
                    self._rerouted += 1
                    self._dispatch(t, edge, self._failover_task(it),
                                   count_escalated=False)
            else:
                live[edge] = batch
        if not live:
            return
        if self.track is not None:
            # cross-camera association: every live track query's embedded
            # detections, fleet-wide, in ONE fused similarity launch per
            # tick (same launch budget discipline as triage).  Runs before
            # the edge_only split so both cascade and edge_only schemes
            # track; cloud_only has no ticks, so it never associates.
            tb: Dict[Tuple[int, int], List[Item]] = {}
            for edge, batch in live.items():
                for it in batch:
                    if (it.query in self._track_qs
                            and it.emb is not None
                            and not self.queries.is_shed(it.query)
                            and self.queries.live_on(it.query, edge)):
                        tb.setdefault((it.query, edge), []).append(it)
            if tb:
                for done, upd in self.track.tick(t, tb):
                    self.events.push(done, upd)
        if self.sc.scheme == "edge_only":
            for edge, batch in live.items():
                for it in batch:
                    self._enqueue(t, edge, Task(it, "classify",
                                                it.conf > 0.5))
            return
        # split each edge batch along the query axis, holding back items
        # whose query can't be served on this edge yet: while the cloud
        # fine-tunes (or the weights ride the downlink), that query's
        # escalations are blocked by construction — nothing of it triages
        ready: Dict[Tuple[int, int], List[Item]] = {}
        for edge, batch in live.items():
            for it in batch:
                if self.queries.is_shed(it.query):
                    # admission refused this query: its detections drop
                    # (counted), they never defer and never triage
                    self._shed_items += 1
                elif self.queries.live_on(it.query, edge):
                    ready.setdefault((it.query, edge), []).append(it)
                elif self.queries.is_retired(it.query):
                    # straggler of a retired query: the edge answers with
                    # the pre-trained prior (no CQ model to consult)
                    self._enqueue(t, edge, Task(it, "classify",
                                                it.conf > 0.5))
                else:
                    self._deferred.setdefault((it.query, edge),
                                              []).append(it)
                    self._deferred_count[it.query] = \
                        self._deferred_count.get(it.query, 0) + 1
        if not ready:
            return
        self._triaged_ticks += 1
        if self.superstep.enabled:
            # scan-superstep path: this tick's routes/thresholds come out
            # of ONE fused multi-tick launch (built now if this tick
            # wasn't covered by a previous plan).  Control signals are
            # boundary-held: resampled at the first triaged tick after
            # each boundary event, constant in between.
            if self._ctrl_dirty:
                self._sample_ctrl(t)
            outs, ths = self.superstep.tick_out(tick, ready, self._ctrl)
            if self.sc.scheme == "surveiledge":
                for q, e in ready:
                    a, b = ths[(q, e)]
                    tag = f"{e}" if q == self.queries.default \
                        else f"{e}q{q}"
                    self.db.put(f"alpha{tag}", a)
                    self.db.put(f"beta{tag}", b)
                for key in [k for k in ready
                            if k[1] in self._ctrl.overloaded]:
                    shed = ready.pop(key)
                    self.bus.publish(
                        f"alerts/edge{key[1]}/shed_batch",
                        dict(t=t, query=key[0], items=len(shed)))
                    for it in shed:
                        self._rerouted += 1
                        self._dispatch(t, key[1],
                                       Task(it, "reclassify", None),
                                       count_escalated=False,
                                       exclude_src=True)
        else:
            self.triage_stage.refresh(t, sorted(ready))
            if self.sc.scheme == "surveiledge":
                for q, e in ready:
                    st = self.triage_stage.states[(q, e)]
                    tag = f"{e}" if q == self.queries.default \
                        else f"{e}q{q}"
                    self.db.put(f"alpha{tag}", st.alpha)
                    self.db.put(f"beta{tag}", st.beta)
                # a home edge that can't drain its queue within the gate
                # sheds this tick's raw batch — every query's — across
                # cloud/edges via Eq. 7 (the overloaded home has maximal
                # Q*t, so it is effectively skipped)
                overloaded = {e for _, e in ready
                              if self.sched.nodes[e].drain_time
                              > self.sc.offload_drain_s}
                for key in [k for k in ready if k[1] in overloaded]:
                    shed = ready.pop(key)
                    self.bus.publish(
                        f"alerts/edge{key[1]}/shed_batch",
                        dict(t=t, query=key[0], items=len(shed)))
                    for it in shed:
                        self._rerouted += 1
                        self._dispatch(t, key[1],
                                       Task(it, "reclassify", None),
                                       count_escalated=False,
                                       exclude_src=True)
                if self.sc.alert_threshold_drift is not None:
                    self._check_drift(t, ready)
            if not ready:
                return
            outs = self.triage_stage.triage_tick(ready)
        if not ready:
            return
        sc_spec = self.sc.speculative_escalation
        for (q, edge), items in ready.items():
            routes, slots, conf_used = outs[(q, edge)]
            for it, route, slot, cal in zip(items, routes, slots,
                                            conf_used):
                if route == ESCALATE and slot >= 0:
                    decision = None                 # cloud-model's call
                elif route == ESCALATE:             # capacity overflow:
                    # stays un-escalated; the edge decides with its LIVE
                    # (calibrated) confidence, same value the kernel
                    # routed on
                    decision = bool(cal > 0.5)
                else:
                    decision = route == ACCEPT
                task = Task(it, "classify", decision)
                if decision is None and sc_spec:
                    # speculative escalation: remember the verdict the
                    # edge's CQ would have given — it is served the
                    # instant the upload starts (see _on_done) and
                    # reconciled when the cloud answers
                    task.provisional = bool(cal > 0.5)
                self._enqueue(t, edge, task)

    def _check_drift(self, t: float,
                     ready: Dict[Tuple[int, int], List[Item]]) -> None:
        """Alert (once per (query, edge) row, latched) when Eqs. 8-9 have
        walked a row's (alpha, beta) further than ``alert_threshold_drift``
        from the scheme prototype — the health signal an operator watches
        to spot a bracket collapsing shut under sustained load."""
        a0, b0 = self._base_th
        for key in ready:
            if key in self._drift_alerted:
                continue
            st = self.triage_stage.states[key]
            if abs(st.alpha - a0) + abs(st.beta - b0) \
                    > self.sc.alert_threshold_drift:
                self._drift_alerted.add(key)
                self.bus.publish(
                    f"alerts/edge{key[1]}/threshold_drift",
                    dict(t=t, query=key[0], alpha=round(st.alpha, 4),
                         beta=round(st.beta, 4)))

    def _failover_task(self, it: Item, prior: Optional[Task] = None) -> Task:
        """A dead edge's work re-homed to a survivor: under edge_only the
        peer re-runs the CQ model (conf > 0.5); otherwise the heavyweight
        re-classifier answers.  A stranded speculative reclassify keeps its
        provisional verdict — the edge already served it, so the re-homed
        cloud answer must still reconcile against it."""
        if self.sc.scheme == "edge_only":
            return Task(it, "classify", it.conf > 0.5)
        task = Task(it, "reclassify", None)
        if prior is not None and prior.phase == "reclassify":
            task.provisional = prior.provisional
            task.t_provisional = prior.t_provisional
        return task

    def _fail_node(self, t: float, node: int) -> None:
        """Edge death: drop it from Eq. 7, re-dispatch its queued and
        in-flight work to survivors."""
        self.sched.mark_down(node)
        stranded = self.nodes.fail(t, node)
        self.sched.nodes[node].queue_len = 0
        self.db.put(f"Q{node}", 0)
        self.bus.publish(f"alerts/edge{node}/failover",
                         dict(t=t, stranded=len(stranded)))
        for task in stranded:
            self._rerouted += 1
            self._dispatch(t, node, self._failover_task(task.item, task),
                           count_escalated=False)
        # items parked on this edge waiting for CQ weights die with it:
        # survivors' accurate models answer them (the weights that were in
        # flight to the dead edge are simply never applied)
        for key in [k for k in self._deferred if k[1] == node]:
            for it in self._deferred.pop(key):
                self._rerouted += 1
                self._dispatch(t, node, self._failover_task(it),
                               count_escalated=False)
        for it in self._release.pop(node, []):
            self._rerouted += 1
            self._dispatch(t, node, self._failover_task(it),
                           count_escalated=False)

    def _on_done(self, t: float, node: int, task: Task, svc: float) -> None:
        if node in self.nodes.dead:
            return                               # work was re-dispatched
        self.nodes.complete(node)
        # The estimator sees SERVICE time only.  Transfer time is the
        # link's (Transport accumulates it); feeding it here would let one
        # WAN burst permanently inflate the cloud's t_0 while wan_backlog
        # separately charges the same congestion in Eq. 7 — double-counted.
        # Reclassify observations on an edge run reclassify_factor x the CQ
        # cost; normalize them so t_j stays a per-CQ-item estimate and a
        # classify/reclassify mix cannot bias drain_time (Eqs. 7-9).
        # (Known residual: Q_j * t_j prices a reclassify-laden queue in
        # CQ units, underestimating its true drain; pricing per-phase
        # queue composition is the fuller alternative the paper's Eq. 7
        # doesn't model either.)
        obs = svc
        if task.phase == "reclassify" and node != CLOUD:
            obs = svc / self.sc.reclassify_factor
        self.sched.on_complete(node, obs)
        self.db.put(f"t{node}", self.sched.nodes[node].estimator.t)
        self.db.put(f"Q{node}", self.sched.nodes[node].queue_len)
        if task.phase == "reclassify":
            # accurate model == ground truth (paper: ResNet-152) — and an
            # exact label for the home edge's CQ score (feedback loop);
            # a reconciliation FLIP is exactly the label the calibrator
            # most needs, so flips feed the ring buffers like any verdict
            self.feedback.observe(t, task.item)
            if task.provisional is not None:
                # reconcile the speculatively served verdict: accuracy
                # counts the cloud's answer, latency counts the moment
                # the edge actually answered the user
                self._reconciled += 1
                if task.provisional != task.item.is_query:
                    self._flips += 1
                self._finish(t, node, task.item, task.item.is_query,
                             serve_t=task.t_provisional)
            else:
                self._finish(t, node, task.item, task.item.is_query)
        elif task.decision is None:              # escalate: ship onward
            nxt = Task(task.item, "reclassify", None)
            if task.provisional is not None:
                # the upload starts NOW: the edge serves its provisional
                # verdict immediately (counted here, reconciled above)
                nxt.provisional = task.provisional
                nxt.t_provisional = t
                self._provisional += 1
                self._prov_lat_sum += t - task.item.t_arrival
            self._dispatch(t, node, nxt, count_escalated=True)
        else:
            self._finish(t, node, task.item, task.decision)
        if self.nodes.queues[node]:
            self._start_service(t, node)

    # --- driver seam: setup -> handle_event* -> finalize ----------------------
    def setup(self, items: Sequence[Item],
              frontend_timings: Optional[Dict[str, float]] = None) -> None:
        """Build run state and seed the event queue (pops no events —
        that is the driver's job)."""
        sc = self.sc
        self._frontend_timings = frontend_timings
        self.events = EventQueue()
        self.transport = Transport(sc)
        self.nodes = NodeBank(sc, self.service_s, self.rng)
        self.triage_stage = TriageStage(sc, self.sched, self.transport,
                                        self.device)
        self.feedback = FeedbackStage(sc, self.transport, self.device)
        self.queries = QuerySet(sc)
        # cross-camera track queries: the fleet-wide track registry exists
        # only when a track-kind query does (classify-only runs carry zero
        # extra state and stay bit-identical)
        self._track_qs = {q for q, sp in self.queries.specs.items()
                          if sp.kind == "track"}
        self.track = TrackStage(sc, self.transport, self.device) \
            if self._track_qs else None
        self._lat: List[float] = []
        self._dec: List[bool] = []
        self._tru: List[bool] = []
        self._fin: List[float] = []
        self._qid: List[int] = []
        self._escalated = 0
        self._rerouted = 0
        # speculative-escalation accounting: served provisionals, cloud
        # reconciliations, verdict flips, sum of provisional latencies
        self._provisional = 0
        self._reconciled = 0
        self._flips = 0
        self._prov_lat_sum = 0.0
        # (query, edge) -> items waiting for that query's CQ weights to
        # reach that edge; edge -> items released by a delivery, absorbed
        # by the next tick's fused launch
        self._deferred: Dict[Tuple[int, int], List[Item]] = {}
        self._release: Dict[int, List[Item]] = {}
        self._deferred_count: Dict[int, int] = {}
        self._train_total = 0.0
        # admission control (token-bucket tenant quotas + fine-tune
        # backlog shedding): with it on, Fig. 5 fine-tunes SERIALIZE on
        # the cloud (``_train_free_at`` is when it frees up), so a
        # submission wave builds exactly the backlog the controller sheds
        # on.  Off (the default), training stays concurrent —
        # bit-identical to the pre-control-plane engine.
        self.admission = AdmissionController(
            sc.tenants, sc.admission_backlog_s) \
            if (sc.tenants or sc.admission_backlog_s is not None) else None
        self._train_free_at = 0.0
        self._submitted = 0
        self._shed_queries = 0
        self._shed_items = 0
        # per-tier latency cells + SLO breach counts (tiers declared only)
        self._tier_acc = {k: MX._Acc() for k in self._tiers} \
            if self._tiers else None
        self._tier_breach = {k: 0 for k in self._tiers}
        self._drift_alerted: set = set()
        self._base_th = (self.triage_stage._proto.alpha,
                        self.triage_stage._proto.beta)
        self._tick_samples: List[Dict[int, int]] = []
        # streaming windowed aggregates (metrics_window_s): the per-item
        # report arrays stay empty and _finish folds into O(window) cells
        self._agg = MX.StreamingWindows(sc.metrics_window_s) \
            if sc.metrics_window_s is not None else None
        # scan-superstep driver (Scenario.superstep): fuses boundary-free
        # runs of ticks into one scan + triage kernel launch
        self.superstep = SuperstepDriver(self)
        self._ctrl: Optional[Ctrl] = None
        self._ctrl_dirty = True
        self._triaged_ticks = 0
        self._tick_batches: Dict[int, Dict[int, List[Item]]] = {}
        self._tick_order: List[int] = []

        # an item tagged with an undeclared query would defer forever (no
        # lifecycle events ever activate it) and silently vanish from the
        # report — reject the stream up front instead
        unknown = {it.query for it in items} - set(self.queries.specs)
        if unknown:
            raise ValueError(
                f"scenario {sc.name!r}: stream items reference undeclared "
                f"query ids {sorted(unknown)} (declared: "
                f"{sorted(self.queries.specs)})")

        # arrivals: cloud_only streams per item; the cascade/edge_only paths
        # batch each tick's detections into ONE TickArrivals event (the
        # cascade schemes triage it with a single fused fleet launch)
        last_t = max((it.t_arrival for it in items), default=0.0)
        n_ticks = self._n_ticks = max(1, int(math.ceil(
            max(sc.duration_s, last_t + 1e-9) / sc.interval_s)))
        if sc.scheme == "cloud_only":
            for it in items:
                self.events.push(it.t_arrival, Arrive(it))
        else:
            for k, batches in group_arrivals(items, sc.interval_s):
                self.events.push((k + 1) * sc.interval_s,
                                 TickArrivals(batches, k))
                # kept (sorted) for the superstep planner, which packs
                # future arrival ticks into the current fused launch
                self._tick_batches[k] = batches
                self._tick_order.append(k)
        for k in range(1, n_ticks + 1):
            self.events.push(k * sc.interval_s, Sample())
        for t_fail, node in sc.failures:
            self.events.push(t_fail, EdgeFail(node))
        if self.queries.lifecycle:
            for sp in sorted(self.queries.specs.values(),
                             key=lambda s: s.query):
                self.events.push(sp.t_arrive_s,
                                 QueryArrival(sp.query, sp.kind))
                if sp.t_retire_s is not None:
                    self.events.push(sp.t_retire_s, QueryRetire(sp.query))
        if self.feedback.enabled:
            horizon = n_ticks * sc.interval_s
            k = 1
            while k * sc.update_period_s <= horizon + 1e-9:
                self.events.push(k * sc.update_period_s, FeedbackTick())
                k += 1

    def handle_event(self, t: float, ev: object) -> None:
        """Apply ONE event.  Drivers own the loop (SimDriver drains the
        heap; AsyncDriver pumps it from asyncio); this owns the physics —
        every driver funnels through here, which is what makes the
        sim-vs-async differential tests meaningful."""
        sc = self.sc
        if isinstance(ev, BOUNDARY_EVENTS):
            # boundary events mutate state the fused superstep math
            # reads: the boundary-held control signals resample at
            # the next triaged tick (and plans never span this pop —
            # the planner stopped strictly before it)
            self._ctrl_dirty = True
        if isinstance(ev, Sample):
            self._tick_samples.append({
                n: self.nodes.occupancy(n) for n in self.service_s})
            if sc.alert_queue_depth is not None:
                for e in sc.edge_ids:
                    if e in self.nodes.dead:
                        continue
                    occ = self.nodes.occupancy(e)
                    if occ > sc.alert_queue_depth:
                        self.bus.publish(f"alerts/edge{e}/queue_depth",
                                         dict(t=t, depth=occ))
        elif isinstance(ev, Arrive):         # cloud_only
            it = ev.item
            task = Task(it, "reclassify", None)
            done = self.transport.wan_send(t, it.nbytes)
            task.tx_s = done - t
            self.events.push(done, Transfer(CLOUD, task))
        elif isinstance(ev, TickArrivals):
            self._on_tick(t, ev.batches, ev.tick)
        elif isinstance(ev, Transfer):
            if ev.node in self.nodes.dead:   # died while in transit
                self._rerouted += 1
                self._dispatch(t, ev.node, ev.task,
                               count_escalated=False)
            else:
                self._enqueue(t, ev.node, ev.task)
        elif isinstance(ev, EdgeFail):
            if ev.node not in self.nodes.dead:
                self._fail_node(t, ev.node)
        elif isinstance(ev, QueryArrival):
            self._on_query_arrival(t, ev.query)
        elif isinstance(ev, TrainDone):
            if not self.queries.is_retired(ev.query):
                # ship the fresh CQ weights to every live edge over the
                # shared WAN downlink (FIFO: a fleet-wide push
                # serializes, so edges go live staggered)
                for e in sorted(self.sc.edge_ids):
                    if e in self.nodes.dead:
                        continue
                    # weights ship through the quantized wire path
                    # (simulated model: byte accounting only — the
                    # accuracy cost of int8 CQ weights is measured by
                    # the report gate's F2 band, not re-simulated)
                    done, _ = self.transport.ship_update(
                        t, self.sc.cq_nbytes)
                    self.events.push(done, ModelUpdate(
                        e, None, query=ev.query, kind="weights"))
        elif isinstance(ev, QueryRetire):
            self.queries.retire(ev.query)
            self.triage_stage.retire_query(ev.query)
            self.feedback.retire_query(ev.query)
            if self.track is not None:
                # the query's fleet-wide track table dies with it
                self.track.retire_query(ev.query)
            # stragglers still waiting for weights are answered with
            # the pre-trained prior; in-flight escalations complete
            # normally and are still counted
            for key in [k for k in self._deferred if k[0] == ev.query]:
                q, e = key
                for it in self._deferred.pop(key):
                    self._enqueue(t, e, Task(it, "classify",
                                             it.conf > 0.5))
        elif isinstance(ev, ReleaseTick):
            # only fires a launch if this tick boundary had no natural
            # TickArrivals (which would have absorbed the release)
            if self._release:
                self._on_tick(t, {}, ev.tick)
        elif isinstance(ev, FeedbackTick):
            # one fused fleet recalibration launch; the per-row
            # results land as ModelUpdate events at downlink delivery
            for done, update in self.feedback.tick(
                    t, self.nodes.dead, self.queries.retired):
                self.events.push(done, update)
        elif isinstance(ev, ModelUpdate):
            if ev.kind == "weights":
                if ev.edge in self.nodes.dead \
                        or self.queries.is_retired(ev.query):
                    return
                self.queries.activate(ev.query, ev.edge)
                pend = self._deferred.pop((ev.query, ev.edge), None)
                if pend:
                    self._release.setdefault(ev.edge, []).extend(pend)
                    self.events.push(
                        (math.floor(t / sc.interval_s) + 1)
                        * sc.interval_s,
                        ReleaseTick(int(math.floor(t / sc.interval_s))))
            elif ev.kind == "prewarm":
                # predictive hand-off delivered: the edge holds the
                # query's track state hot for prewarm_ttl_s.  A late
                # delivery (target already arrived cold) simply misses —
                # that is the stale-in-flight cost the ablation measures.
                if ev.edge not in self.nodes.dead \
                        and not self.queries.is_retired(ev.query) \
                        and self.track is not None:
                    self.track.apply_prewarm(t, ev.query, ev.edge)
            elif ev.edge not in self.nodes.dead \
                    and not self.queries.is_retired(ev.query):
                # a calibration that retired mid-flight must not undo
                # retire_query's reset
                self.triage_stage.apply_update(ev.query, ev.edge,
                                               ev.params)
        else:
            assert isinstance(ev, ServiceDone), ev
            self._on_done(t, ev.node, ev.task, ev.service_s)

    def _on_query_arrival(self, t: float, query: int) -> None:
        """A query submission reaches the cloud.

        Without admission (the default): the Fig. 5 fine-tune is charged
        immediately and concurrently — bit-identical to the
        pre-control-plane engine.  With admission: the submission first
        passes its tenant's token bucket, then the fine-tune-backlog gate
        (tier-scaled allowance; tier 0 exempt) — a refusal sheds the query
        (its stream items drop, counted) and publishes an
        ``alerts/admission/<reason>`` event; an accepted query's fine-tune
        QUEUES behind the cloud's in-flight ones."""
        sp = self.queries.specs[query]
        if self.admission is not None:
            self._submitted += 1
            backlog = max(0.0, self._train_free_at - t)
            reason = self.admission.admit(t, sp.tenant, sp.tier, backlog)
            if reason is not None:
                self.queries.shed_query(query)
                self._shed_queries += 1
                self.bus.publish(
                    f"alerts/admission/{reason}",
                    dict(t=t, query=query, tenant=sp.tenant, tier=sp.tier,
                         backlog_s=round(backlog, 3)))
                return
            start = max(t, self._train_free_at)
            dt = self.queries.arrive(query, start)
            self.nodes.busy_s[CLOUD] += dt
            self._train_total += dt
            self._train_free_at = start + dt
            self.events.push(start + dt, TrainDone(query))
            return
        # charge the Fig. 5 fine-tune on the cloud; this query's
        # detections defer (its escalations are blocked) until its
        # weights deliver per edge
        dt = self.queries.arrive(query, t)
        self.nodes.busy_s[CLOUD] += dt
        self._train_total += dt
        self.events.push(t + dt, TrainDone(query))

    def register_query(self, sp: QuerySpec) -> None:
        """Admit a runtime-submitted query into every stage's state
        (serving/api.py's ``QueryAPI.submit`` calls this, then pushes the
        ``QueryArrival`` event that starts the lifecycle)."""
        self.queries.register(sp)
        self._tier_of[sp.query] = sp.tier
        tsp = self._tiers.get(sp.tier)
        self.triage_stage.add_query(sp.query,
                                    tsp.weight if tsp is not None else 0.0)
        self.feedback.add_query(sp.query)
        if sp.kind == "track":
            self._track_qs.add(sp.query)
            if self.track is None:
                self.track = TrackStage(self.sc, self.transport, self.device)

    def finalize(self) -> MX.QueryReport:
        """Assemble the QueryReport once the driver has drained the run."""
        sc = self.sc
        qinfo: Dict[int, Dict] = {}
        if sc.queries or len(self.queries.specs) > 1:
            by_query = self.triage_stage.thresholds_by_query()
            for q, sp in sorted(self.queries.specs.items()):
                qinfo[q] = {
                    "train_scheme": sp.train_scheme,
                    "t_arrive_s": sp.t_arrive_s,
                    "t_retire_s": sp.t_retire_s,
                    "train_s": round(self.queries.train_s.get(q, 0.0), 3),
                    "deferred": self._deferred_count.get(q, 0),
                    "live_edges": sorted(self.queries.live_edges[q]),
                    "thresholds": {e: (round(a, 4), round(b, 4))
                                   for e, (a, b) in
                                   sorted(by_query.get(q, {}).items())}
                    if sc.scheme in ("surveiledge", "surveiledge_fixed")
                    else {},
                }
        tier_rows: Dict[int, Dict[str, float]] = {}
        if self._tier_acc is not None:
            for k in sorted(self._tier_acc):
                acc = self._tier_acc[k]
                tier_rows[k] = {
                    "n": acc.n,
                    "mean_latency_s": acc.mean,
                    "p99_latency_s": acc.percentile(0.99),
                    "slo_s": self._tiers[k].slo_s,
                    "slo_breaches": self._tier_breach[k],
                }
        # cross-camera track accounting (absent -> zeros, summary stays
        # schema-identical for classify-only runs)
        trk = self.track
        track_kwargs = dict(
            track_items=trk.items,
            tracks_born=trk.tracks_born,
            track_matches=trk.matches,
            id_switches=trk.id_switches,
            track_opportunities=trk.opportunities,
            track_handoffs=trk.handoffs,
            prewarms_shipped=trk.prewarms,
            prewarm_hits=trk.prewarm_hits,
            track_launches=trk.launches,
        ) if trk is not None else {}
        return MX.QueryReport(
            scenario=sc.name,
            scheme=sc.scheme,
            latencies=np.asarray(self._lat),
            decisions=np.asarray(self._dec, bool),
            truths=np.asarray(self._tru, bool),
            finish_times=np.asarray(self._fin),
            query_ids=np.asarray(self._qid, np.int64),
            queries=qinfo,
            cloud_train_s=self._train_total,
            uploaded_bytes=self.transport.uploaded_bytes,
            lan_bytes=self.transport.lan_bytes,
            downloaded_bytes=self.transport.downloaded_bytes,
            downlink_fp_bytes=self.transport.downlink_fp_bytes,
            model_updates=self.feedback.model_updates,
            provisional=self._provisional,
            reconciled=self._reconciled,
            reconciliation_flips=self._flips,
            provisional_latency_sum=self._prov_lat_sum,
            wan_transfer_s=self.transport.wan_transfer_s,
            lan_transfer_s=self.transport.lan_transfer_s,
            escalated=self._escalated,
            rerouted=self._rerouted,
            kernel_launches=self.triage_stage.launches,
            supersteps=self.superstep.supersteps,
            triaged_ticks=self._triaged_ticks,
            stream=self._agg,
            ticks=self._n_ticks,
            queue_timeline=MX.merge_timelines(self._tick_samples),
            per_node_busy=dict(self.nodes.busy_s),
            per_node_served=dict(self.nodes.served),
            thresholds=self.triage_stage.final_thresholds()
            if sc.scheme in ("surveiledge", "surveiledge_fixed") else {},
            stage_timings={**(self._frontend_timings or {}),
                           "triage_s": self.triage_stage.elapsed_s,
                           **({"associate_s": trk.elapsed_s}
                              if trk is not None else {})},
            alerts=self.alerts.snapshot(),
            submitted_queries=self._submitted,
            shed_queries=self._shed_queries,
            shed_items=self._shed_items,
            tier_latency=tier_rows,
            edge_health={e: self.alerts.health_snapshot(e)
                         for e in sc.edge_ids},
            **track_kwargs,
        )

    def run(self, items: Sequence[Item],
            frontend_timings: Optional[Dict[str, float]] = None
            ) -> MX.QueryReport:
        """setup -> drive (the injected driver, or SimDriver) -> finalize."""
        self.setup(items, frontend_timings)
        (self.driver or SimDriver()).drive(self)
        return self.finalize()


def run_query(scenario: Scenario, *,
              items: Optional[Sequence[Item]] = None,
              frontend: object = "confidence",
              driver: Optional[object] = None,
              device="cuda") -> MX.QueryReport:
    """Run one query scenario end to end and return its ``QueryReport``.

    All knobs are keyword-only; the positional surface is the scenario.

    ``frontend`` picks the detection stream: ``"confidence"`` (default) is
    ``ConfidenceStreamFrontend`` over ``items`` (or ``scenario.items``) — a
    pre-scored stream re-homed onto this scenario's topology, or, with no
    items, the model-free synthetic stream from the camera fleet; a
    ``Frontend`` instance supplies its own stream (mutually exclusive with
    ``items``).  ``"pixel"`` is the paper's full pixel path
    (``PixelFrontend(device=device)``): rendered frames -> the fused
    pixel-cascade kernel -> motion crops -> CQ-classifier confidences,
    with per-stage wall-clock in ``QueryReport.stage_timings``; it renders
    its own stream, so it refuses ``items``.

    ``device`` is where every kernel launch goes: ``"cuda"`` (default)
    runs the hand-written kernels on the card and raises ``RuntimeError``
    where torch finds none; ``"cpu"`` runs their plain PyTorch versions.

    ``driver`` selects the event-loop strategy: None/``SimDriver`` for the
    classic DES, or ``repro_torch.serving.engine.AsyncDriver`` to pump the
    same events from asyncio (virtual or wall clock) — the real-time
    serving mode with live query submission
    (``repro_torch.serving.api.QueryAPI``).
    """
    if isinstance(frontend, str):
        if frontend == "pixel":
            if items is not None:
                raise ValueError(
                    "items= cannot combine with frontend='pixel' "
                    "(the pixel path renders its own stream)")
            frontend = PixelFrontend(device=device)
        elif frontend == "confidence":
            frontend = ConfidenceStreamFrontend(
                items if items is not None else scenario.items)
        else:
            raise ValueError(
                f"unknown frontend {frontend!r} (expected 'confidence', "
                "'pixel', or a Frontend instance)")
    elif items is not None:
        raise ValueError("pass either items= or frontend=, not both "
                         "(a custom frontend produces its own stream)")
    pipe = QueryPipeline(scenario, driver=driver, device=resolve_device(device))
    return pipe.run(frontend.stream(scenario),
                    frontend_timings=frontend.timings)
