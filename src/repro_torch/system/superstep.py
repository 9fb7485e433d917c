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
mutually independent; each shard's launch runs on its own rows with no
collective, and the outputs are concatenated).

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
its plain PyTorch version on the CPU.  Under ``Scenario.shard_fleet`` the
driver splits the row axis over ``launch.mesh.make_fleet_mesh``: one
launch a shard, each on its shard's device.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import time
from typing import Dict, FrozenSet, List, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import can_shard_fleet, fleet_specs
from repro_torch.kernels import superstep as _ss
from repro_torch.kernels.buckets import MAX_SUPERSTEP_ELEMS, bucket
from repro_torch.launch.mesh import make_fleet_mesh
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


def _row_blocks(spec, t: torch.Tensor, n: int):
    """``t`` split into ``n`` contiguous blocks along the dim ``spec``
    names "fleet" (all of ``t`` ``n`` times where none does)."""
    if "fleet" not in spec:
        return [t] * n
    return list(torch.chunk(t, n, dim=spec.index("fleet")))


@functools.lru_cache(maxsize=None)
def _superstep_fn(capacity: int, n_shards: int):
    """The superstep program for a shard count: ``fn(conf, th0, mask,
    drain, gains)`` on tensors of one device -> (routes, slots, ths) on
    that device.

    ``n_shards`` = 1 is one ``kernels.superstep.superstep`` launch.
    Otherwise the row axis R splits into ``n_shards`` contiguous blocks as
    ``fleet_specs`` lays them out, over ``make_fleet_mesh(n_shards)`` of
    the inputs' device type: each block is one launch on its shard's
    device, and the outputs come back concatenated.  Rows are
    independent, so no collective is needed and the result is
    bit-identical to one launch."""
    sp = fleet_specs()
    names = ("conf", "thresholds", "mask", "drain", "gains")

    def fn(conf, th0, mask, drain, gains):
        if n_shards == 1:
            return _ss.superstep(conf, th0, mask, drain, gains,
                                 capacity=capacity)
        if conf.shape[1] % n_shards:
            raise ValueError(f"superstep: {conf.shape[1]} rows do not "
                             f"split into {n_shards} shards")
        mesh = make_fleet_mesh(n_shards, device_type=conf.device.type)
        blocks = [_row_blocks(sp[k], t, n_shards)
                  for k, t in zip(names, (conf, th0, mask, drain, gains))]
        outs = [_ss.superstep(*(b[i].to(dev) for b in blocks),
                              capacity=capacity)
                for i, dev in enumerate(mesh.devices)]
        return tuple(torch.cat([o[j].to(conf.device) for o in outs],
                               dim=sp[k].index("fleet"))
                     for j, k in enumerate(("routes", "slots", "ths_out")))

    return fn


class SuperstepDriver:
    """Plans and executes scan-supersteps for one pipeline run.

    The pipeline calls ``tick_out`` from ``_on_tick`` for every tick
    with ready work.  On a plan miss the driver greedily accumulates the
    current tick plus future arrival ticks — stopping at the scenario's
    K, at the next event boundary, or at the element cap — executes the
    fused program ONCE, and caches each covered tick's outputs; the
    following ticks of the run then pop their slice with no device work.
    Under ``Scenario.shard_fleet`` the launch splits over the fleet mesh's
    ``n_shards`` row shards where the padded row bucket divides evenly
    (else it stays one launch), and ``stage.launches`` counts each.
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
        # the fleet mesh the row axis splits over (None: one launch)
        self.mesh = None
        if self.enabled and sc.shard_fleet:
            self.mesh = make_fleet_mesh(
                None if sc.shard_fleet is True else int(sc.shard_fleet),
                device_type=pipe.device.type)
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

        n_shards = self.mesh.size if (self.mesh is not None and
                                      can_shard_fleet(self.mesh, Rb)) else 1
        fn = _superstep_fn(sc.escalation_capacity, n_shards)
        dev = pipe.device
        routes, slots, ths = (a.cpu().numpy() for a in fn(
            *(torch.from_numpy(a).to(dev)
              for a in (conf, th0, mask, drain, gains))))
        stage.launches += n_shards
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
