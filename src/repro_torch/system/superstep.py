"""Scan-superstep driver: K scheduler ticks fused into ONE kernel launch.

The per-tick driver (``pipeline._on_tick`` + ``triage.triage_tick``) pays
one host->device round trip per scheduler tick: pack the tick's
(query, edge) batches, launch the fused triage kernel, pull the routes
back.  At metropolis scale (>=1024 edges, ~10k cameras, dozens of live
queries, 10 Hz ticks) the host loop — not the kernel — is the bottleneck.

This module fuses runs of consecutive ticks into one device program:

  host (numpy)                      device (ONE launch per superstep)
  ------------                      ---------------------------------
  segment the event queue into      ``kernels.superstep.superstep``:
  boundary-free runs of ticks;        per (query, edge) row, the Eqs.
  pack a (S, R, N) confidence         8-9 threshold update carried over
  slab over the run's ACTIVE          the tick axis (masked to the ticks
  (query, edge) keys; apply live      where the row had items), each
  Platt calibration per row           tick's row triaged against that
  (feedback.calibrate_row)            tick's thresholds
  fold routes/slots/thresholds      <- (S, R, N) routes/slots,
  back into per-tick plans             (S, R, 2) per-tick thresholds

Axes: S = ticks in the run (<= scenario.superstep), R = |union of
(query, edge) keys with >=1 ready item in the run| — the fleet's
(Q, E) grid is ~99.8% empty per tick at metropolis scale, so the slab
is packed over active keys, not the dense grid.  R is the axis
``distributed.sharding.fleet_specs`` shards across devices (rows are
mutually independent; the kernel runs shard-local with no collectives).

Correctness contract (the differential harness in
``tests/test_superstep.py`` enforces all of it bit-exactly):

* **Boundaries split supersteps, never the reverse.**  A superstep may
  only cover ticks that process strictly before the next queued
  ``events.BOUNDARY_EVENTS`` time — those events mutate state the fused
  math reads (query/node liveness, calibrations, control signals).  No
  boundary event is ever created by pure tick/DES flow, so
  ``EventQueue.next_boundary()`` is always known at plan time.
* **K-invariance.**  The run's control signals (Eq. 7 escalation-target
  drain, per-edge queue drains, the overload-shed set) are sampled once
  at the first triaged tick after each boundary and held until the next
  one — by the *pipeline*, independent of K — so any segmentation of a
  boundary-free run produces bit-identical decisions, thresholds and
  latencies.  ``superstep=1`` is therefore a per-tick reference driver
  for any ``superstep=K``, which is exactly what the differential tests
  compare.
* **Threshold arithmetic is f32 end to end.**  The kernel carries
  (alpha, beta) in f32, every operation rounded on its own; the host
  write-back stores the f32 values (f32 -> f64 -> f32 round trips are
  exact), so splitting a run at any point does not change the trajectory.

The launch goes to the pipeline's ``device``: the CUDA kernel on the card,
its plain PyTorch version on the CPU.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, FrozenSet, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import superstep as _ss
from repro_torch.kernels.buckets import MAX_SUPERSTEP_ELEMS, bucket
from repro_torch.serving.simulator import Item
from repro_torch.system.feedback import calibrate_row

#: a (query, edge) pair — the row key of the packed slab
Key = Tuple[int, int]
#: per-tick triage outputs: key -> (routes, slots, conf_used), trimmed
TickOuts = Dict[Key, Tuple[np.ndarray, np.ndarray, np.ndarray]]
#: per-tick post-update thresholds: key -> (alpha, beta)
TickThs = Dict[Key, Tuple[float, float]]


@dataclasses.dataclass(frozen=True)
class Ctrl:
    """Boundary-held control signals (sampled by ``pipeline._sample_ctrl``
    at the first triaged tick after each boundary event, constant until
    the next boundary).

    ``esc_drain`` is the Eq. 7 escalation-target drain (incl. WAN backlog
    when the target is the cloud); ``edge_drain`` each edge's own queue
    drain; ``overloaded`` the edges whose drain exceeds the shed gate."""
    esc_drain: float
    edge_drain: Dict[int, float]
    overloaded: FrozenSet[int]


class SuperstepDriver:
    """Plans and executes scan-supersteps for one pipeline run.

    The pipeline calls ``tick_out`` from ``_on_tick`` for every tick
    with ready work.  On a plan miss the driver greedily accumulates the
    current tick plus future arrival ticks — stopping at the scenario's
    K, at the next event boundary, or at the element cap — executes the
    fused program ONCE, and caches each covered tick's outputs; the
    following ticks of the run then pop their slice with no device work.
    ``Scenario.shard_fleet`` is accepted and runs as the one launch.
    """

    def __init__(self, pipe):
        self.pipe = pipe
        sc = pipe.sc
        self.sc = sc
        self.enabled = (sc.superstep is not None
                        and sc.scheme in ("surveiledge",
                                          "surveiledge_fixed"))
        self.k = max(1, int(sc.superstep or 1))
        self.supersteps = 0
        self._plans: Dict[int, Tuple[TickOuts, TickThs]] = {}

    # --- per-tick entry point -------------------------------------------------
    def tick_out(self, tick: int, ready: Dict[Key, List[Item]],
                 ctrl: Ctrl) -> Tuple[TickOuts, TickThs]:
        """This tick's (routes, slots, conf_used) per key + the per-key
        post-update thresholds.  ``ready`` is the tick's PRE-shed ready
        map (threshold updates and db snapshots cover keys the shed then
        drops, matching the per-tick driver's ordering)."""
        plan = self._plans.pop(tick, None)
        if plan is None:
            self._build(tick, ready, ctrl)
            plan = self._plans.pop(tick)
        return plan

    # --- planning + one fused launch ------------------------------------------
    def _build(self, k0: int, ready0: Dict[Key, List[Item]],
               ctrl: Ctrl) -> None:
        t0 = time.perf_counter()
        pipe, sc = self.pipe, self.sc
        adaptive = sc.scheme == "surveiledge"
        shed = ctrl.overloaded if adaptive else frozenset()
        next_boundary = pipe.events.next_boundary()

        # Greedy segmentation: the current tick always belongs to its
        # own superstep; future arrival ticks join while (a) the run
        # stays under K triaged ticks, (b) the tick processes STRICTLY
        # before the next boundary event (conservative: a boundary at
        # the exact tick boundary cuts the run — cutting early is always
        # bit-exact, absorbing an event never is), and (c) the padded
        # slab stays under the element cap.  Ticks whose pure
        # classification comes back empty are skipped, not counted: the
        # pipeline never asks for a plan on an empty tick.
        ticks = [k0]
        readies = [ready0]
        keys = set(ready0)
        max_n = max(len(v) for v in ready0.values())
        order = pipe._tick_order
        i = bisect.bisect_right(order, k0)
        while len(ticks) < self.k and i < len(order):
            k = order[i]
            if (k + 1) * sc.interval_s >= next_boundary - 1e-9:
                break
            i += 1
            ready = pipe._ready_of(pipe._tick_batches[k])
            if not ready:
                continue
            cand_keys = keys | set(ready)
            cand_n = max(max_n, max(len(v) for v in ready.values()))
            if (bucket(len(ticks) + 1, 1) * bucket(len(cand_keys))
                    * bucket(cand_n)) > MAX_SUPERSTEP_ELEMS:
                break
            ticks.append(k)
            readies.append(ready)
            keys, max_n = cand_keys, cand_n

        # pack the slab over the run's active keys only
        keys_sorted = sorted(keys)
        ki = {key: r for r, key in enumerate(keys_sorted)}
        S, R = len(ticks), len(keys_sorted)
        Sb, Rb, Nb = bucket(S, 1), bucket(R), bucket(max_n)
        conf = np.full((Sb, Rb, Nb), -1.0, np.float32)
        mask = np.zeros((Sb, Rb), bool)
        th0 = np.tile(np.asarray([1.0, 0.0], np.float32), (Rb, 1))
        drain = np.zeros(Rb, np.float32)
        stage = pipe.triage_stage
        for r, key in enumerate(keys_sorted):
            st = stage.states[key]
            th0[r] = (st.alpha, st.beta)
            if adaptive:
                drain[r] = max(ctrl.edge_drain[key[1]], ctrl.esc_drain)
        for s, ready in enumerate(readies):
            for key, items in ready.items():
                r = ki[key]
                if adaptive:
                    mask[s, r] = True
                if key[1] in shed:
                    continue        # row stays pad: outputs never read
                row = conf[s, r]
                row[:len(items)] = [it.conf for it in items]
                calibrate_row(row, len(items), stage.calibrations[key])
        proto = next(iter(stage.states.values()))
        g1u = proto.gamma1 if proto.gamma1_up is None else proto.gamma1_up
        gains = np.asarray([proto.gamma1, g1u, proto.gamma2,
                            sc.interval_s], np.float32)

        dev = pipe.device
        routes, slots, ths = (a.cpu().numpy() for a in _ss.superstep(
            *(torch.from_numpy(a).to(dev)
              for a in (conf, th0, mask, drain, gains)),
            capacity=sc.escalation_capacity))
        stage.launches += 1
        self.supersteps += 1

        # fold back into per-tick plans
        for s, (k, ready) in enumerate(zip(ticks, readies)):
            outs: TickOuts = {}
            ths_k: TickThs = {}
            for key, items in ready.items():
                r = ki[key]
                if adaptive:
                    ths_k[key] = (float(ths[s, r, 0]),
                                  float(ths[s, r, 1]))
                if key[1] not in shed:
                    n = len(items)
                    outs[key] = (routes[s, r, :n], slots[s, r, :n],
                                 conf[s, r, :n])
            self._plans[k] = (outs, ths_k)

        # write the end-of-run thresholds back so the next superstep (or
        # the end-of-run report) starts where this one ended.  ONLY the
        # adaptive scheme: the fixed scheme never refreshes, and writing
        # f32-cast copies would perturb its frozen f64 (alpha, beta).
        if adaptive:
            for r, key in enumerate(keys_sorted):
                stage.states[key] = dataclasses.replace(
                    stage.states[key],
                    alpha=float(ths[S - 1, r, 0]),
                    beta=float(ths[S - 1, r, 1]))
        stage.elapsed_s += time.perf_counter() - t0
