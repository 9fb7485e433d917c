"""Fleet cascade stage: per-(query, edge) Eqs. 8-9 state + one fused
launch per tick.

Every scheduler tick, ALL live queries' detection batches across ALL live
edges are packed into one (Q, E, N) confidence tensor (lanes right-padded
with -1.0, which always routes to 'reject'; absent (query, edge) rows are
all-pad) alongside the (Q, E, 2) tensor of each row's *current* adaptive
thresholds, and triaged by a single ``ops.triage_fleet`` launch — the
per-tick kernel-launch count is 1, not E and not Q·E.  The pack is
numpy on the host; the padded tensor moves to the run's ``device`` (the
card, unless the caller asked for the CPU), and routes and slots come
back to the host for the event loop.  Before packing,
each (query, edge) row's raw confidences pass through its *live* Platt
calibration (cloud->edge feedback loop, ``system/feedback.py``) —
identity until the first ``ModelUpdate`` delivers.

Thresholds are per-(query, edge) state: each pair runs its own Eqs. 8-9
update, driven by the drain of "its chosen queue" — the busier of the
edge's own queue (where classification tasks land, across every query
sharing the edge) and the node Eq. 7 would hand an escalation to
(including WAN backlog; computed once per tick, it is the same target for
every row).  A loaded edge therefore tightens every query's bracket on
that edge, while the same query on an idle edge widens its own — and two
queries with different score quality on one edge diverge through their
separate feedback calibrations.  A retired query's rows simply stop
appearing in the pack, freeing that edge capacity (its escalation buffer
rows) for the survivors.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import CLOUD, Scheduler
from repro_torch.core.thresholds import ThresholdState
from repro_torch.kernels import ops
from repro_torch.serving.simulator import Item
from repro_torch.system.feedback import IDENTITY, calibrate_row
from repro_torch.system.scenario import Scenario
from repro_torch.system.transport import Transport

# route codes emitted by the triage kernel
ACCEPT, REJECT, ESCALATE = 0, 1, 2

#: a (query, edge) pair — the row key of the fused (Q, E, N) launch
Key = Tuple[int, int]


class TriageStage:
    """Per-(query, edge) adaptive thresholds + the fused triage hot path."""

    def __init__(self, sc: Scenario, sched: Scheduler, transport: Transport,
                 device: torch.device):
        self.sc = sc
        self.sched = sched
        self.transport = transport
        self.device = device         # where the fused launch runs
        # Per-(query, edge) Eqs. 8-9 state (the paper runs the adaptation
        # on every edge device per CQ model; one global (alpha, beta)
        # would let one hot edge — or one blurry query — drag every
        # bracket shut).  The fixed scheme freezes one shared pair.
        if sc.scheme == "surveiledge_fixed":
            a, b = sc.fixed_thresholds or (0.8, 0.1)
            proto = ThresholdState(alpha=a, beta=b, gamma1=0.0,
                                   gamma2=b / max(1.0 - a, 1e-6))
        else:
            proto = ThresholdState(gamma1_up=0.005)
        self._proto = proto
        self.states: Dict[Key, ThresholdState] = {
            (q, e): proto for q in sc.query_ids for e in sc.edge_ids}
        # per-(query, edge) live Platt calibration (a, b): identity until a
        # ModelUpdate *delivers* over the WAN downlink (feedback loop)
        self.calibrations: Dict[Key, Tuple[float, float]] = {
            (q, e): IDENTITY for q in sc.query_ids for e in sc.edge_ids}
        # priority tiers (control plane): a query's tier weight amplifies
        # the drain signal its Eqs. 8-9 rows see, so a high-priority
        # query's brackets tighten EARLIER under the same load — it backs
        # off from escalating (keeping its latency inside the SLO) while
        # best-effort queries keep riding the shared escalation path.
        # Empty/zero weights keep every row's update bit-identical.
        self.tier_weight: Dict[int, float] = {}
        if sc.tiers:
            w_of = {ts.tier: ts.weight for ts in sc.tiers}
            tier_of = {sp.query: sp.tier for sp in sc.queries}
            self.tier_weight = {
                q: w for q in sc.query_ids
                if (w := w_of.get(tier_of.get(q, 0), 0.0)) > 0.0}
        self.launches = 0
        self.elapsed_s = 0.0         # wall clock inside triage_tick

    # --- Eqs. 8-9, once per (query, edge) per tick ----------------------------
    def refresh(self, t: float, keys: Iterable[Key]) -> None:
        """Advance each listed (query, edge) row's (alpha, beta) by one
        Eqs. 8-9 step.

        The escalation-target drain (argmin Eq. 7 cost, incl. WAN backlog
        for the cloud) is fleet-global and computed once; each row then
        maxes it against its edge's *own* queue drain — which counts every
        query sharing that edge, so multi-query load couples the brackets
        of co-located queries exactly as shared hardware would."""
        if self.sc.scheme != "surveiledge":
            return
        try:
            d = self.sched.select_node(
                extra_cost={CLOUD: self.transport.wan_backlog(t)})
        except ValueError:
            d = CLOUD
        esc_drain = self.sched.nodes[d].drain_time
        if d == CLOUD:
            esc_drain += self.transport.wan_backlog(t)
        for key in keys:
            q, e = key
            drain = max(self.sched.nodes[e].drain_time, esc_drain)
            w = self.tier_weight.get(q)
            if w:
                drain *= 1.0 + w
            self.states[key] = self.states[key].update(
                drain, 1.0, self.sc.interval_s)

    # --- the fused launch -----------------------------------------------------
    def triage_tick(self, batches: Dict[Key, List[Item]]
                    ) -> Dict[Key, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Triage every (query, edge) tick batch in ONE kernel launch.

        ``batches`` maps (query, edge) -> that row's items this tick.
        Returns per-key ``(routes, slots, conf_used)`` arrays trimmed to
        the true batch lengths — ``conf_used`` is the (calibrated)
        confidence the kernel actually routed on, so downstream fallback
        decisions (escalation-capacity overflow) judge with the row's
        live calibration, not the stale raw score."""
        if not batches:
            return {}
        t0 = time.perf_counter()
        qs = sorted({q for q, _ in batches})
        es = sorted({e for _, e in batches})
        qi = {q: i for i, q in enumerate(qs)}
        ei = {e: i for i, e in enumerate(es)}
        n = max(len(b) for b in batches.values())
        conf = np.full((len(qs), len(es), n), -1.0, np.float32)
        # absent (query, edge) rows stay all-pad; give them inert
        # thresholds (1, 0) like the kernel's own pad rows
        thresholds = np.tile(np.asarray([1.0, 0.0], np.float32),
                             (len(qs), len(es), 1))
        for (q, e), items in batches.items():
            row = conf[qi[q], ei[e]]
            row[:len(items)] = [it.conf for it in items]
            # live recalibration from the cloud->edge feedback loop; pad
            # lanes stay -1.0 (always 'reject', never a slot).  Shared
            # with the superstep slab pack — see feedback.calibrate_row.
            calibrate_row(row, len(items), self.calibrations[(q, e)])
            st = self.states[(q, e)]
            thresholds[qi[q], ei[e]] = (st.alpha, st.beta)
        routes, slots, _ = ops.triage_fleet(
            conf, thresholds, capacity=self.sc.escalation_capacity,
            device=self.device)
        self.launches += 1
        routes, slots = routes.cpu().numpy(), slots.cpu().numpy()
        out = {
            key: (routes[qi[key[0]], ei[key[1]], :len(items)],
                  slots[qi[key[0]], ei[key[1]], :len(items)],
                  conf[qi[key[0]], ei[key[1]], :len(items)])
            for key, items in batches.items()}
        self.elapsed_s += time.perf_counter() - t0
        return out

    def add_query(self, query: int, weight: float = 0.0) -> None:
        """Register a runtime-submitted query (live API): fresh threshold
        rows from the scheme prototype, identity calibration, optional
        tier weight — the same starting state a declared query gets."""
        for e in self.sc.edge_ids:
            self.states.setdefault((query, e), self._proto)
            self.calibrations.setdefault((query, e), IDENTITY)
        if weight > 0.0:
            self.tier_weight[query] = weight

    def apply_update(self, query: int, edge: int,
                     params: Tuple[float, float]) -> None:
        """A calibration ``ModelUpdate`` delivered: this (query, edge) row
        triages later ticks with the new Platt map (earlier ticks already
        ran stale)."""
        self.calibrations[(query, edge)] = params

    def retire_query(self, query: int) -> None:
        """Drop a retired query's live calibrations (its threshold states
        stay readable for the end-of-run report; its rows never enter
        ``triage_tick`` again because the pipeline stops producing them)."""
        for key in list(self.calibrations):
            if key[0] == query:
                self.calibrations[key] = IDENTITY

    def final_thresholds(self, query: Optional[int] = None
                         ) -> Dict[int, Tuple[float, float]]:
        """Per-edge (alpha, beta) at end of run for one query (default: the
        lowest-id query — for single-query runs, THE query)."""
        if query is None:
            query = min(q for q, _ in self.states)
        return {e: (s.alpha, s.beta)
                for (q, e), s in self.states.items() if q == query}

    def thresholds_by_query(self) -> Dict[int, Dict[int, Tuple[float, float]]]:
        """query -> edge -> final (alpha, beta) (per-query report rows)."""
        out: Dict[int, Dict[int, Tuple[float, float]]] = {}
        for (q, e), s in self.states.items():
            out.setdefault(q, {})[e] = (s.alpha, s.beta)
        return out
