"""Scenario definitions for the end-to-end cloud-edge query pipeline.

A ``Scenario`` fixes everything the harness needs: topology (edge speed
multipliers + one cloud), link capacities, the camera fleet and query
duration, the scheme, and optional stress events (traffic bursts, edge
failures).  Paper settings (Tables II-IV) and beyond-paper settings are
plain factory functions registered in ``SCENARIOS``.

Scenarios can either carry a pre-scored item stream (``items`` — e.g. the
benchmark workload scored by the fine-tuned CQ model from
``repro_torch.serving.workload``) or let the harness synthesize one cheaply with
``synthetic_confidence_stream`` (confidence drawn from class-conditional
Beta distributions — no model in the loop, for tests/examples).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.data import synthetic_video as SV
from repro_torch.kernels.buckets import validate_fleet_dims, validate_frame_hw
from repro_torch.serving.api import TenantSpec, TierSpec
from repro_torch.serving.simulator import Item
from repro_torch.system.queries import QuerySpec

SCHEMES = ("surveiledge", "surveiledge_fixed", "edge_only", "cloud_only")

# Fig. 5's accuracy side of the training-scheme trade, expressed as the
# class-conditional Beta sharpness of each query's synthetic CQ
# confidences: All-Fine-tune scores sharpest (it paid ~num_cameras-x the
# training time), No-Fine-tune ships instantly but its pre-trained-only
# scores blur toward the middle of the axis.
_SCHEME_BETAS: Dict[str, Tuple[Tuple[float, float], Tuple[float, float]]] = {
    "surveiledge": ((8.0, 2.0), (2.0, 8.0)),
    "all_finetune": ((9.0, 1.5), (1.5, 9.0)),
    "no_finetune": ((4.0, 2.5), (2.5, 4.0)),
}


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    scheme: str = "surveiledge"
    # --- fleet ---------------------------------------------------------------
    num_cameras: int = 8
    duration_s: float = 120.0
    interval_s: float = 1.0                 # scheduler tick == sampling period
    # --- topology ------------------------------------------------------------
    edge_speeds: Tuple[float, ...] = (1.0,)  # service-time multiplier per edge
    edge_service_s: float = 0.08             # 1.0x edge per-item CQ inference
    cloud_speedup: float = 6.0               # cloud GPU vs 1.0x edge CPU
    reclassify_factor: float = 2.0           # accurate model vs CQ model cost
    offload_drain_s: float = 2.0             # Eq. 7 sheds raw batches above
    #                                          this home-edge drain time
    # --- links ---------------------------------------------------------------
    uplink_MBps: float = 0.5                 # shared WAN FIFO, edge -> cloud
    downlink_MBps: float = 5.0               # shared WAN FIFO, cloud -> edge
    lan_MBps: float = 10.0                   # edge <-> edge, non-contending
    rtt_s: float = 0.1
    # --- cascade -------------------------------------------------------------
    escalation_capacity: int = 64            # per edge per tick (kernel buffer)
    fixed_thresholds: Optional[Tuple[float, float]] = None
    # --- feedback loop (cloud -> edge online recalibration) ------------------
    update_period_s: Optional[float] = None  # None disables the loop (the
    #                                          ablation); else one fused
    #                                          calibrate launch per period
    update_nbytes: int = 64 * 1024           # per-edge downlink payload (the
    #                                          recalibrated CQ head)
    feedback_window: int = 256               # per-edge (score, truth) buffer
    feedback_min_count: int = 8              # labels needed before fitting
    feedback_max_age_periods: float = 2.0    # labels older than this many
    #                                          update periods age out of the
    #                                          fit (recency bounds staleness
    #                                          under drift)
    # --- stress events -------------------------------------------------------
    burst_boost: Optional[float] = None      # override CameraSpec.busy_boost
    burst_rate: Optional[float] = None       # override CameraSpec.base_rate
    failures: Tuple[Tuple[float, int], ...] = ()   # (t_s, edge node id)
    # concept drift: at drift_at_s the class-conditional Beta parameters of
    # the synthetic confidence stream switch from (8,2)/(2,8) to drift_beta
    # ((query_a, query_b), (other_a, other_b)).  The default is gain-style
    # drift — query scores compress into the middle of the axis while
    # clutter compresses low, so the classes STAY separable but the frozen
    # thresholds (and the raw conf > 0.5 fallback cut) sit in the wrong
    # place; a monotone recalibration can recover it, which is exactly what
    # the feedback loop fits
    drift_at_s: Optional[float] = None
    drift_beta: Tuple[Tuple[float, float], Tuple[float, float]] = \
        ((5.0, 5.0), (1.2, 12.0))
    # --- runtime query lifecycle ---------------------------------------------
    # explicit continuous queries with staggered arrivals/retirements; empty
    # means ONE implicit query live for the whole run (the pre-lifecycle
    # engine, bit-identical).  Each arrival charges its Fig. 5 fine-tune on
    # the cloud and ships per-edge CQ weights down the WAN before serving.
    queries: Tuple[QuerySpec, ...] = ()
    train_step_s: float = 0.05               # cloud seconds per fine-tune step
    #                                          (Fig. 5 cost model's knob)
    cq_nbytes: int = 4 * 1024 * 1024         # per-edge CQ weight shipment
    # --- control plane (serving layer: admission, priority, alerting) ---------
    # Priority tiers: each QuerySpec.tier indexes this tuple; a tier's SLO
    # and pressure weight thread into the Eq. 7 allocator and the Eqs. 8-9
    # bracket updates (repro_torch.serving.api.TierSpec).  Empty keeps the
    # tierless engine bit-identical.
    tiers: Tuple[TierSpec, ...] = ()
    # Per-tenant submission quotas (token bucket; repro_torch.serving.api).
    tenants: Tuple[TenantSpec, ...] = ()
    # Enables admission control at QueryArrival: fine-tunes SERIALIZE on
    # the cloud (one training run at a time — the realistic regime where a
    # backlog can exist at all) and submissions shed on quota exhaustion
    # or when the training backlog exceeds the tier's allowance (tier 0
    # exempt; tier k's allowance is this * 0.5**(k-1)).  None keeps the
    # legacy concurrent-training path bit-identical.
    admission_backlog_s: Optional[float] = None
    # health alerting lines (None disables each alert kind): a sampled
    # edge queue depth above alert_queue_depth, or an Eqs. 8-9 bracket
    # drifted more than alert_threshold_drift (L1 on (alpha, beta)) from
    # its starting point, publishes on alerts/edge<e>/...
    alert_queue_depth: Optional[int] = None
    alert_threshold_drift: Optional[float] = None
    # --- bandwidth endgame ----------------------------------------------------
    # ship every WAN-downlink model artifact (per-query CQ weights, Platt
    # calibration heads) int8-quantized (distributed/quantize.py wire
    # format): the link is charged the real quantized byte count — scale/
    # zero-point overhead included — and shipped calibration values
    # round-trip encode->decode, so the edge applies the (slightly lossy)
    # parameters it actually received.  False keeps the full-width fp path
    # as the differential reference; QueryReport.downlink_fp_bytes records
    # the fp-equivalent cost either way, so one row shows the reduction.
    quantize_downlink: bool = False
    # serve escalations speculatively: while an escalated crop's WAN upload
    # is in flight, the edge emits its provisional CQ verdict (calibrated
    # conf > 0.5) immediately and reconciles when the cloud's reclassify
    # verdict lands — the stale-in-flight ModelUpdate delivery semantics
    # generalized to verdicts.  Escalated items' reported latency becomes
    # the provisional serve time; accuracy still counts the reconciled
    # (cloud) verdict, and the flip rate is reported and gated.
    speculative_escalation: bool = False
    # --- cross-camera track queries (QuerySpec.kind == "track") ---------------
    # Knobs are inert unless a track query is declared; classify-only
    # scenarios are bit-identical to the pre-track engine.
    embedding_dim: int = 32                  # re-ID embedding width D
    track_objects: int = 4                   # persistent trajectory targets
    #                                          (query class) per track query
    track_distractors: int = 2               # persistent non-query movers
    track_speed_px_s: Tuple[float, float] = (24.0, 48.0)  # |vx| draw range
    # (warm, cold) cosine acceptance floors: an edge that is warm for the
    # query (a live track was just there, or a pre-warm delivered) accepts
    # cross-camera matches down to `warm`; a cold edge demands `cold` —
    # which only a same-camera continuation clears.  The gap is exactly
    # what the predictive hand-off buys.
    track_thresholds: Tuple[float, float] = (0.85, 0.97)
    track_ttl_s: float = 3.0                 # unseen tracks retire after this
    predictive_handoff: bool = True          # ship pre-warms ahead of targets
    prewarm_nbytes: int = 4096               # downlink payload per pre-warm
    prewarm_ttl_s: float = 12.0              # delivered pre-warm stays warm
    # --- stream --------------------------------------------------------------
    seed: int = 0
    items: Optional[Sequence[Item]] = None   # injected pre-scored stream
    frame_hw: Optional[Tuple[int, int]] = None   # pixel path: camera frame
    #                                              size override (H, W)
    # --- superstep execution (metropolis scale) -------------------------------
    # None runs the legacy per-tick live-signal loop (bit-identical to every
    # pre-superstep release).  K >= 1 switches the cascade schemes to
    # boundary-sampled control semantics: the Eqs. 8-9 drain signals and the
    # overload-shedding gate are sampled once per host event boundary (query
    # lifecycle, failures, model deliveries, feedback ticks) and held
    # constant between boundaries, which makes results invariant to K — up
    # to K consecutive ticks then fuse into ONE superstep kernel launch
    # (system/superstep.py).  K=1 is the same semantics driven tick by tick:
    # the differential harness proves K=1 == K=N bit-exactly.
    superstep: Optional[int] = None
    # shard the superstep's folded row axis: True splits it over every
    # visible device of the run's type (one card, or the CPU: one shard),
    # an int n into n row shards round-robin over them (shards may share
    # a device); each shard is one superstep launch (system/superstep.py)
    shard_fleet: Union[bool, int] = False
    # accumulate the report in streaming windowed aggregates of this width
    # instead of O(items) per-item arrays (system/metrics.py); None keeps
    # the exact per-item arrays
    metrics_window_s: Optional[float] = None

    def __post_init__(self):
        # plain ValueError, never assert: `python -O` strips asserts, and a
        # scenario with a bogus scheme or thresholds must fail loudly either
        # way.  dataclasses.replace() re-runs this, so with_scheme and the
        # ablation replaces are covered too.
        if self.scheme not in SCHEMES:
            raise ValueError(
                f"scenario {self.name!r}: unknown scheme {self.scheme!r} "
                f"(expected one of {SCHEMES})")
        if self.fixed_thresholds is not None:
            a, b = self.fixed_thresholds
            if not 0.5 <= a <= 1.0:
                raise ValueError(
                    f"scenario {self.name!r}: fixed alpha={a} must satisfy "
                    f"0.5 <= alpha <= 1 (Eq. 8 clamp)")
            if not 0.0 <= b < 0.5:
                raise ValueError(
                    f"scenario {self.name!r}: fixed beta={b} must satisfy "
                    f"0 <= beta < 0.5 (Eq. 9 range)")
        if not isinstance(self.shard_fleet, (bool, int)) or (
                not isinstance(self.shard_fleet, bool)
                and self.shard_fleet < 1):
            raise ValueError(
                f"scenario {self.name!r}: shard_fleet={self.shard_fleet!r} "
                f"must be a bool or a shard count >= 1")
        if self.update_period_s is not None and self.update_period_s <= 0:
            raise ValueError(
                f"scenario {self.name!r}: update_period_s="
                f"{self.update_period_s} must be positive (or None)")
        if self.queries:
            ids = [sp.query for sp in self.queries]
            if len(set(ids)) != len(ids):
                raise ValueError(
                    f"scenario {self.name!r}: duplicate query ids in "
                    f"queries={ids}")
        if self.train_step_s < 0:
            raise ValueError(
                f"scenario {self.name!r}: train_step_s={self.train_step_s} "
                f"must be >= 0")
        if self.interval_s <= 0:
            raise ValueError(
                f"scenario {self.name!r}: interval_s={self.interval_s} "
                f"must be positive")
        if self.duration_s <= 0:
            raise ValueError(
                f"scenario {self.name!r}: duration_s={self.duration_s} "
                f"must be positive")
        if self.num_cameras < 1:
            raise ValueError(
                f"scenario {self.name!r}: num_cameras={self.num_cameras} "
                f"must be >= 1")
        # fleet dims checked against the kernel padding-bucket table here,
        # where the numbers are still legible — not at first launch, where
        # an oversized fold surfaces as an opaque kernel shape error
        validate_fleet_dims(self.name, len(self.query_ids), self.num_edges,
                            self.escalation_capacity)
        # frame sizes checked against the pixel-cascade tile table for the
        # same reason: a bad frame_hw must raise here, not as a kernel
        # block-shape error at the first rendered tick
        if self.frame_hw is not None:
            validate_frame_hw(self.name, *self.frame_hw)
        if self.superstep is not None and self.superstep < 1:
            raise ValueError(
                f"scenario {self.name!r}: superstep={self.superstep} must "
                f"be >= 1 (or None for the legacy per-tick loop)")
        # --- control plane ----------------------------------------------------
        if self.tiers:
            declared = sorted(ts.tier for ts in self.tiers)
            if declared != list(range(len(self.tiers))):
                raise ValueError(
                    f"scenario {self.name!r}: tiers must declare contiguous "
                    f"tier ids 0..{len(self.tiers) - 1}, got {declared}")
        max_tier = len(self.tiers) - 1 if self.tiers else 0
        tenant_names = {tn.tenant for tn in self.tenants}
        if len(tenant_names) != len(self.tenants):
            raise ValueError(
                f"scenario {self.name!r}: duplicate tenant names in "
                f"tenants={[tn.tenant for tn in self.tenants]}")
        for sp in self.queries:
            if sp.tier > max_tier:
                raise ValueError(
                    f"scenario {self.name!r}: query {sp.query} declares "
                    f"tier={sp.tier} but only tiers 0..{max_tier} exist "
                    f"(declare Scenario.tiers)")
            if sp.tenant and self.tenants and sp.tenant not in tenant_names:
                raise ValueError(
                    f"scenario {self.name!r}: query {sp.query} declares "
                    f"tenant={sp.tenant!r}, not one of "
                    f"{sorted(tenant_names)}")
        if self.admission_backlog_s is not None \
                and self.admission_backlog_s <= 0:
            raise ValueError(
                f"scenario {self.name!r}: admission_backlog_s="
                f"{self.admission_backlog_s} must be positive (or None)")
        if self.alert_queue_depth is not None and self.alert_queue_depth < 1:
            raise ValueError(
                f"scenario {self.name!r}: alert_queue_depth="
                f"{self.alert_queue_depth} must be >= 1 (or None)")
        if self.alert_threshold_drift is not None \
                and self.alert_threshold_drift <= 0:
            raise ValueError(
                f"scenario {self.name!r}: alert_threshold_drift="
                f"{self.alert_threshold_drift} must be positive (or None)")
        # the admission path (serialized fine-tunes, shed queries) and
        # nonzero tier weights both feed per-tick live signals the fused
        # scan cannot reproduce — the control plane requires the per-tick
        # driver, exactly like the feedback loop requires deliveries to
        # land at tick boundaries
        if self.superstep is not None:
            if self.admission_backlog_s is not None:
                raise ValueError(
                    f"scenario {self.name!r}: admission control "
                    f"(admission_backlog_s) requires superstep=None — "
                    f"shed/serialization decisions are per-arrival live "
                    f"signals the scan path does not model")
            if any(ts.weight > 0 for ts in self.tiers):
                raise ValueError(
                    f"scenario {self.name!r}: tier weights > 0 require "
                    f"superstep=None — SLO pressure is a per-item live "
                    f"signal the scan path does not model")
        if self.metrics_window_s is not None and self.metrics_window_s <= 0:
            raise ValueError(
                f"scenario {self.name!r}: metrics_window_s="
                f"{self.metrics_window_s} must be positive (or None for "
                f"per-item arrays)")
        # --- cross-camera track queries ---------------------------------------
        if self.track_query_ids:
            if self.superstep is not None:
                raise ValueError(
                    f"scenario {self.name!r}: track queries require "
                    f"superstep=None — track birth/hand-off decisions are "
                    f"per-tick live signals the scan path does not model")
            if self.embedding_dim < self.num_cameras:
                raise ValueError(
                    f"scenario {self.name!r}: embedding_dim="
                    f"{self.embedding_dim} must be >= num_cameras="
                    f"{self.num_cameras} (per-camera appearance tints are "
                    f"orthonormal in the embedding space)")
            warm, cold = self.track_thresholds
            if not 0.0 < warm <= cold <= 1.0:
                raise ValueError(
                    f"scenario {self.name!r}: track_thresholds="
                    f"{self.track_thresholds} must satisfy "
                    f"0 < warm <= cold <= 1")
            if self.track_ttl_s <= 0 or self.prewarm_ttl_s <= 0:
                raise ValueError(
                    f"scenario {self.name!r}: track_ttl_s and prewarm_ttl_s "
                    f"must be positive")
            if self.track_objects < 1:
                raise ValueError(
                    f"scenario {self.name!r}: track_objects="
                    f"{self.track_objects} must be >= 1")
            if self.track_distractors < 0:
                raise ValueError(
                    f"scenario {self.name!r}: track_distractors="
                    f"{self.track_distractors} must be >= 0")

    @property
    def num_edges(self) -> int:
        return len(self.edge_speeds)

    @property
    def edge_ids(self) -> Tuple[int, ...]:
        return tuple(range(1, self.num_edges + 1))

    @property
    def query_ids(self) -> Tuple[int, ...]:
        """Every declared query id (sorted); ``(0,)`` for the implicit
        single-query run."""
        return tuple(sorted(sp.query for sp in self.queries)) or (0,)

    @property
    def track_query_ids(self) -> Tuple[int, ...]:
        """Declared cross-camera track queries (sorted; empty when the
        scenario is classify-only)."""
        return tuple(sorted(sp.query for sp in self.queries
                            if sp.kind == "track"))

    def with_scheme(self, scheme: str) -> "Scenario":
        """Same scenario under another query scheme (validated in
        ``__post_init__`` — raises ``ValueError``, survives ``python -O``)."""
        return dataclasses.replace(self, scheme=scheme)


def scenario_cameras(sc: Scenario) -> List[SV.CameraSpec]:
    """The scenario's camera fleet with its overrides applied.

    Shared by the confidence-stream synthesizer and the pixel frontend so
    both paths see the *same* cameras: burst overrides reshape the traffic
    profile, ``frame_hw`` shrinks/grows the rendered frames (pixel path
    only — the confidence path never renders)."""
    cams = SV.make_cameras(sc.num_cameras, seed=sc.seed)
    if (sc.burst_boost is None and sc.burst_rate is None
            and sc.frame_hw is None):
        return cams
    h, w = sc.frame_hw if sc.frame_hw is not None else (None, None)
    return [dataclasses.replace(
        c,
        busy_boost=sc.burst_boost if sc.burst_boost is not None
        else c.busy_boost,
        base_rate=sc.burst_rate if sc.burst_rate is not None
        else c.base_rate,
        height=h if h is not None else c.height,
        width=w if w is not None else c.width) for c in cams]


def frame_schedule(sc: Scenario) -> np.ndarray:
    """Per-camera frame-capture schedule for the pixel path.

    Returns a (T, C) matrix of capture instants: camera ``j`` samples one
    frame triple per scheduler tick ``k`` at ``k*interval_s + stagger_j``,
    where the per-camera stagger is a deterministic draw in [0, interval_s)
    — a fleet's captures spread across the tick instead of all landing on
    the same instant, as real cameras' sampling clocks do."""
    ts = np.arange(0.0, sc.duration_s, sc.interval_s)
    rng = np.random.default_rng(sc.seed + 13)
    stagger = rng.uniform(0.0, sc.interval_s, sc.num_cameras)
    return ts[:, None] + stagger[None, :]


def _query_substream(sc: Scenario, cams: List[SV.CameraSpec],
                     rng: np.random.Generator, query: int,
                     betas: Tuple[Tuple[float, float], Tuple[float, float]],
                     t0: float, t1: float) -> List[Item]:
    """One query's detections: Poisson arrivals from the camera fleet,
    confidence from the query's class-conditional Betas, windowed to the
    query's [t0, t1) lifetime.

    All random draws are vectorized (one Poisson matrix over ticks x
    cameras, then per-camera class/confidence/jitter vectors) and the
    lifetime window is a post-draw mask, so a windowed query's draws stay
    deterministic under seed regardless of its lifetime."""
    (qa0, qb0), (oa0, ob0) = betas
    ts = np.arange(0.0, sc.duration_s, sc.interval_s)              # (T,)
    period = np.asarray([c.busy_period_s for c in cams])           # (C,)
    phase = 2 * np.pi * ts[:, None] / period[None, :] \
        + np.asarray([c.busy_phase for c in cams])[None, :]
    rates = np.asarray([c.base_rate for c in cams]) * (
        1.0 + np.asarray([c.busy_boost for c in cams])
        * np.maximum(0.0, np.sin(phase)) ** 2)                     # (T, C)
    counts = rng.poisson(rates * sc.interval_s)                    # (T, C)
    items: List[Item] = []
    for j, cam in enumerate(cams):
        n = int(counts[:, j].sum())
        if n == 0:
            continue
        cls = rng.choice(SV.NUM_CLASSES, size=n, p=cam.class_mix)
        is_query = cls == SV.QUERY_CLASS
        conf = np.where(is_query, rng.beta(qa0, qb0, n),
                        rng.beta(oa0, ob0, n))
        t_arr = np.repeat(ts, counts[:, j]) \
            + rng.uniform(0, sc.interval_s, n)
        if sc.drift_at_s is not None:
            # concept drift: items after drift_at_s draw from the drifted
            # class-conditional Betas (drawn AFTER the stationary draws so
            # drift-free scenarios keep bit-identical streams per seed)
            (qa, qb), (oa, ob) = sc.drift_beta
            drifted = np.where(is_query, rng.beta(qa, qb, n),
                               rng.beta(oa, ob, n))
            conf = np.where(t_arr >= sc.drift_at_s, drifted, conf)
        keep = (t_arr >= t0) & (t_arr < t1)
        edge = cam.cam_id % sc.num_edges + 1
        items.extend(
            Item(t_arrival=float(t), camera=cam.cam_id, edge_device=edge,
                 conf=float(c), is_query=bool(q), query=query)
            for t, c, q in zip(t_arr[keep], conf[keep], is_query[keep]))
    return items


def _track_substream(sc: Scenario, cams: List[SV.CameraSpec],
                     rng: np.random.Generator, query: int,
                     betas: Tuple[Tuple[float, float], Tuple[float, float]],
                     t0: float, t1: float) -> List[Item]:
    """One track query's detections: trajectory-aware ground truth.

    Unlike ``_query_substream``'s memoryless Poisson clutter, a track
    query's world is a set of PERSISTENT objects with stable identities:
    ``sc.track_objects`` query-class targets plus ``sc.track_distractors``
    non-query movers, each travelling at constant signed speed along a 1-D
    chain of ``num_cameras`` camera fields (camera width
    ``SV.CAMERA_FIELD_W`` px, wrapping at the ends).  Every scheduler tick
    each object is observed once by whichever camera its world position
    falls in, yielding an ``Item`` that carries

    * ``gt_track`` — the object's stable id (the ID-switch metric's truth),
    * ``emb`` — a unit re-ID embedding built from three orthogonal parts:
      ``c*base[obj] + a*tint[camera] + b*noise``, where the per-camera
      tints are orthonormal (QR) and each object's base is projected off
      the tint subspace.  Same-camera re-observations then score
      ``~c^2 + a^2`` cosine (clears the cold floor), cross-camera ones
      ``~c^2`` (clears only the warm floor — the hand-off's whole value),
      and distinct objects ``~0``,
    * ``conf`` / ``is_query`` — the usual class-conditional Beta draw, so
      the same items ride the classify cascade untouched.

    All draws sit on the fixed (tick, object) grid before the lifetime
    window masks them — windowing never shifts the rng stream.
    """
    (qa, qb), (oa, ob) = betas
    C = sc.num_cameras
    W = SV.CAMERA_FIELD_W
    D = sc.embedding_dim
    total = sc.track_objects + sc.track_distractors
    ts = np.arange(0.0, sc.duration_s, sc.interval_s)              # (T,)
    T = len(ts)
    # per-object trajectory state
    x0 = rng.uniform(0.0, C * W, total)
    speed = rng.uniform(*sc.track_speed_px_s, total)
    sign = np.where(rng.uniform(size=total) < 0.5, -1.0, 1.0)
    vx = speed * sign
    # per-camera appearance tints: orthonormal rows (needs D >= C, checked
    # in __post_init__), so cross-camera interference is exactly zero
    tint = np.linalg.qr(rng.normal(size=(D, C)))[0].T[:C]          # (C, D)
    base = rng.normal(size=(total, D))
    base -= (base @ tint.T) @ tint        # project off the tint subspace
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    a_tint, b_noise = 0.30, 0.05
    c_base = float(np.sqrt(1.0 - a_tint**2 - b_noise**2))
    # fixed-grid draws: (T, total)
    x = (x0[None, :] + vx[None, :] * ts[:, None]) % (C * W)
    cam = (x // W).astype(np.int64)                                # (T, total)
    jitter = rng.uniform(0.0, sc.interval_s, (T, total))
    is_q = np.arange(total) < sc.track_objects
    conf = np.where(is_q[None, :], rng.beta(qa, qb, (T, total)),
                    rng.beta(oa, ob, (T, total)))
    noise = rng.normal(size=(T, total, D))
    noise /= np.linalg.norm(noise, axis=-1, keepdims=True)
    emb = c_base * base[None] + a_tint * tint[cam] + b_noise * noise
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    t_arr = ts[:, None] + jitter
    keep = (t_arr >= t0) & (t_arr < t1)
    items: List[Item] = []
    for k, o in zip(*np.nonzero(keep)):
        cj = int(cam[k, o])
        items.append(Item(
            t_arrival=float(t_arr[k, o]), camera=cj,
            edge_device=cj % sc.num_edges + 1,
            conf=float(conf[k, o]), is_query=bool(is_q[o]), query=query,
            emb=emb[k, o].astype(np.float32), gt_track=int(o)))
    return items


def synthetic_confidence_stream(sc: Scenario) -> List[Item]:
    """Model-free item stream: Poisson arrivals from the procedural camera
    fleet, edge confidence drawn from class-conditional Beta distributions
    (query objects ~ Beta(8,2), others ~ Beta(2,8)) — overlapping enough
    that the [beta, alpha] escalation band carries real mass.

    With explicit ``sc.queries``, every query contributes its own
    substream (independent per-query rng, lifetime-windowed, confidence
    sharpness set by its Fig. 5 ``train_scheme`` via ``_SCHEME_BETAS``):
    each live CQ watches the same cameras but detects its own objects, so
    total traffic scales with concurrent live queries."""
    cams = scenario_cameras(sc)
    if not sc.queries:
        items = _query_substream(
            sc, cams, np.random.default_rng(sc.seed), 0,
            _SCHEME_BETAS["surveiledge"], 0.0, float("inf"))
    else:
        items = []
        for sp in sorted(sc.queries, key=lambda s: s.query):
            t1 = sp.t_retire_s if sp.t_retire_s is not None else float("inf")
            gen = _track_substream if sp.kind == "track" \
                else _query_substream
            items.extend(gen(
                sc, cams, np.random.default_rng((sc.seed, 1001 + sp.query)),
                sp.query, _SCHEME_BETAS[sp.train_scheme],
                sp.t_arrive_s, t1))
    items.sort(key=lambda it: it.t_arrival)
    return items


# --- paper settings (Tables II-IV) -------------------------------------------

def single_edge(**kw) -> Scenario:
    """Table II: one edge + cloud."""
    return Scenario(name="single_edge", edge_speeds=(1.0,), **kw)


def homogeneous_multi_edge(**kw) -> Scenario:
    """Table III: three identical edges + cloud."""
    return Scenario(name="homogeneous_multi_edge",
                    edge_speeds=(1.0, 1.0, 1.0), **kw)


def heterogeneous_multi_edge(**kw) -> Scenario:
    """Table IV: 2/4/8-core edge analogues (1.0 / 0.5 / 0.25 x service)."""
    return Scenario(name="heterogeneous_multi_edge",
                    edge_speeds=(1.0, 0.5, 0.25), **kw)


# --- beyond-paper settings ----------------------------------------------------

def bursty_crowds(**kw) -> Scenario:
    """Flash-crowd traffic: every camera's busy peaks are ~3x the paper
    profile, driving the adaptive thresholds through their full range."""
    return Scenario(name="bursty_crowds", edge_speeds=(1.0, 1.0, 1.0),
                    burst_boost=9.0, burst_rate=1.5, **kw)


def straggler_edge(**kw) -> Scenario:
    """One 4x-slow straggler edge, and it *fails outright* two-thirds into
    the run — Eq. 7 must route around it, then the harness re-dispatches its
    queued work and re-homes its cameras' frames to the surviving nodes."""
    duration = kw.pop("duration_s", 120.0)
    return Scenario(name="straggler_edge", edge_speeds=(4.0, 1.0, 0.5),
                    duration_s=duration,
                    failures=((duration * 2 / 3, 1),), **kw)


def city_scale(num_cameras: int = 512, num_edges: int = 64,
               num_failures: int = 6, **kw) -> Scenario:
    """Fleet-scale operating point: >= 64 heterogeneous edges serving
    >= 512 cameras, with *rolling* failures — a handful of distinct edges
    dying one after another across the run, so Eq. 7 keeps re-routing and
    camera fleets keep re-homing while the system stays under load.

    The floors are pinned (a smaller request is bumped up): this scenario
    exists to exercise the fused fleet-triage launch and the per-edge
    threshold state at scale, not to shrink down.  Links and the cloud are
    sized city-like — a fat shared uplink and a cloud cluster an order of
    magnitude faster than the paper's single GPU."""
    num_cameras = max(num_cameras, 512)
    num_edges = max(num_edges, 64)
    duration = kw.pop("duration_s", 60.0)
    seed = kw.pop("seed", 0)
    rng = np.random.default_rng(seed + 77)
    # heterogeneous service speeds: mostly 1x/0.5x, some fast 0.25x racks
    # and a tail of 2x-slow strugglers (service-time multipliers)
    speeds = tuple(float(s) for s in rng.choice(
        (0.25, 0.5, 1.0, 2.0), size=num_edges, p=(0.15, 0.3, 0.4, 0.15)))
    fail_edges = rng.choice(np.arange(1, num_edges + 1),
                            size=num_failures, replace=False)
    failures = tuple(
        (duration * (i + 1) / (num_failures + 1), int(e))
        for i, e in enumerate(fail_edges))
    return Scenario(name="city_scale", edge_speeds=speeds,
                    num_cameras=num_cameras, duration_s=duration,
                    seed=seed, failures=failures,
                    uplink_MBps=8.0, lan_MBps=50.0, cloud_speedup=40.0,
                    **kw)


def metropolis(num_cameras: int = 10240, num_edges: int = 1024,
               num_queries: int = 24, num_failures: int = 3,
               **kw) -> Scenario:
    """Metropolis operating point: >= 1024 edges, ~10k cameras, dozens of
    concurrent CQs, 10 Hz sampling — the scale where per-tick Python
    dispatch dominates wall clock long before the kernels do, and the
    reason the scan-superstep path exists.

    The floors are pinned like ``city_scale``'s: >= 1024 edges, and at
    least one camera per edge.  Runs with ``superstep=128`` (boundary-free
    tick runs fuse into ONE superstep kernel launch each),
    ``shard_fleet=True`` (the row axis splits over every visible card), and
    streaming windowed report aggregates (``metrics_window_s``) so report
    memory is O(windows), not O(items).

    The workload shape is chosen so boundary events cluster in the opening
    act: every query registers within the first 2% of the run (city
    operators set up their query book up front), the per-edge CQ weight
    pushes drain over a fat downlink shortly after (each delivery is a
    host boundary — 24 queries x 1024 edges of them — so they must
    finish early or they fragment every superstep), and the rolling edge
    failures land inside that same window — after which the fleet serves
    dozens of concurrent queries across long boundary-free stretches,
    which is precisely where one superstep replaces up to K host-loop
    iterations.  The online recalibration loop stays off by default: each
    calibration shipment's delivery is a host boundary, and at this scale
    the study of interest is fleet orchestration, not the feedback loop
    (``drifting_city`` remains its measuring stick; pass
    ``update_period_s=...`` to combine them).
    """
    num_edges = max(num_edges, 1024)
    num_cameras = max(num_cameras, num_edges)
    num_queries = max(num_queries, 12)
    duration = kw.pop("duration_s", 60.0)
    interval = kw.pop("interval_s", 0.1)
    seed = kw.pop("seed", 0)
    rng = np.random.default_rng(seed + 177)
    speeds = tuple(float(s) for s in rng.choice(
        (0.25, 0.5, 1.0, 2.0), size=num_edges, p=(0.15, 0.3, 0.4, 0.15)))
    fail_edges = rng.choice(np.arange(1, num_edges + 1),
                            size=num_failures, replace=False)
    failures = tuple(
        (duration * (0.04 + 0.015 * i), int(e))
        for i, e in enumerate(fail_edges))
    queries = kw.pop("queries", tuple(
        QuerySpec(q,
                  t_arrive_s=duration * 0.02 * q / num_queries,
                  t_retire_s=duration * 0.95 if q >= num_queries - 2
                  else None,
                  train_scheme="no_finetune" if q % 3 == 2
                  else "surveiledge")
        for q in range(num_queries)))
    return Scenario(name="metropolis", edge_speeds=speeds,
                    num_cameras=num_cameras, duration_s=duration,
                    interval_s=interval, seed=seed, failures=failures,
                    queries=queries,
                    burst_rate=kw.pop("burst_rate", 0.02),
                    escalation_capacity=kw.pop("escalation_capacity", 8),
                    edge_service_s=kw.pop("edge_service_s", 0.05),
                    uplink_MBps=kw.pop("uplink_MBps", 16.0),
                    downlink_MBps=kw.pop("downlink_MBps", 2000.0),
                    lan_MBps=kw.pop("lan_MBps", 100.0),
                    cloud_speedup=kw.pop("cloud_speedup", 80.0),
                    cq_nbytes=kw.pop("cq_nbytes", 32 * 1024),
                    train_step_s=kw.pop("train_step_s", duration / 4000.0),
                    superstep=kw.pop("superstep", 128),
                    shard_fleet=kw.pop("shard_fleet", True),
                    metrics_window_s=kw.pop("metrics_window_s",
                                            duration / 12.0),
                    **kw)


def drifting_city(num_cameras: int = 12, num_edges: int = 4,
                  **kw) -> Scenario:
    """Concept drift mid-run: the edge CQ model's confidence distribution
    decays a third of the way in (query scores slump toward the reject
    band, clutter compresses low), so a frozen calibration starts silently
    dropping true query objects below beta.

    This is the feedback loop's measuring stick: by default the loop is ON
    (``update_period_s`` set — every period the cloud fits all edges'
    Platt recalibration in ONE fused ``ops.calibrate_fleet`` launch and
    ships it down the WAN downlink); replace ``update_period_s=None`` for
    the open-loop ablation, and compare ``accuracy_F2`` /
    ``accuracy_timeline`` between the two (``examples/run_scenarios.py``
    emits both rows automatically)."""
    duration = kw.pop("duration_s", 90.0)
    drift_at = kw.pop("drift_at_s", duration / 3.0)
    update = kw.pop("update_period_s", 6.0)
    speeds = tuple(1.0 if i % 2 == 0 else 0.5 for i in range(num_edges))
    # operating point: compute is ample (fast service, shedding only in
    # extremis) but the per-edge ESCALATION budget is tight, so the edge's
    # own verdicts — the thing calibration improves — carry real weight
    return Scenario(name="drifting_city", edge_speeds=speeds,
                    num_cameras=num_cameras, duration_s=duration,
                    burst_rate=kw.pop("burst_rate", 4.0),
                    escalation_capacity=kw.pop("escalation_capacity", 3),
                    edge_service_s=kw.pop("edge_service_s", 0.04),
                    offload_drain_s=kw.pop("offload_drain_s", 8.0),
                    quantize_downlink=kw.pop("quantize_downlink", True),
                    speculative_escalation=kw.pop(
                        "speculative_escalation", True),
                    drift_at_s=drift_at, update_period_s=update, **kw)


def multi_query_city(num_cameras: int = 12, num_edges: int = 4,
                     **kw) -> Scenario:
    """Three concurrent CQs with staggered arrivals and overlapping
    lifetimes — the paper's headline workload (queries against a live
    fleet), one per Fig. 5 training scheme so the training-time/accuracy
    trade shows up in ONE run's per-query report rows:

      q0 (surveiledge)  — arrives at t=0, short cluster fine-tune, serves
                          almost the whole run
      q1 (all_finetune) — arrives a fifth in, pays the ~num_cameras-x
                          per-camera fine-tune (its early detections wait
                          in the deferral buffers — visible head-of-query
                          latency), retires before the run ends
      q2 (no_finetune)  — arrives mid-run, ships instantly, but its
                          pre-trained-only confidences are blurrier

    All three queries' detections across all edges still triage in ONE
    fused (Q, E, N) triage launch per scheduler tick, and Eq. 7 prices
    every node by its total load across the queries sharing it.
    ``train_step_s`` scales with duration so shrunken smoke runs keep the
    same training-time-to-lifetime proportions."""
    duration = kw.pop("duration_s", 90.0)
    queries = kw.pop("queries", (
        QuerySpec(0, 0.0, None, "surveiledge"),
        QuerySpec(1, duration * 0.2, duration * 0.85, "all_finetune"),
        QuerySpec(2, duration * 0.45, None, "no_finetune")))
    speeds = tuple(1.0 if i % 2 == 0 else 0.5 for i in range(num_edges))
    return Scenario(name="multi_query_city", edge_speeds=speeds,
                    num_cameras=num_cameras, duration_s=duration,
                    queries=queries,
                    quantize_downlink=kw.pop("quantize_downlink", True),
                    speculative_escalation=kw.pop(
                        "speculative_escalation", True),
                    train_step_s=kw.pop("train_step_s", duration / 1800.0),
                    update_period_s=kw.pop("update_period_s", 10.0), **kw)


def query_churn(num_cameras: int = 10, num_edges: int = 3, **kw) -> Scenario:
    """Query churn under concept drift: five CQs arriving and retiring
    across the run, including an arrival during another query's Fig. 5
    fine-tune (the cloud trains both back to back while their detections
    defer), a retire-mid-drift (q0 leaves just after the confidence
    distributions slip, while its last escalations are still in flight),
    and a late post-drift arrival whose fresh fine-tune is born into the
    drifted regime.

    The online recalibration loop is OFF here by default: at this
    operating point escalation is cheap, so the cloud's labels are
    censored to the [beta, alpha] band and a per-(query, edge) Platt fit
    extrapolates that biased sample to the whole axis — measurably worse
    than serving stale (the loop's measuring stick, with honest
    label-generating shedding, is ``drifting_city``).  Pass
    ``update_period_s=...`` to study exactly that failure mode."""
    duration = kw.pop("duration_s", 90.0)
    drift_at = kw.pop("drift_at_s", duration / 3.0)
    queries = kw.pop("queries", (
        QuerySpec(0, 0.0, duration * 0.4, "surveiledge"),
        QuerySpec(1, duration * 0.1, duration * 0.7, "surveiledge"),
        QuerySpec(2, duration * 0.15, None, "no_finetune"),
        QuerySpec(3, duration * 0.12, duration * 0.55, "all_finetune"),
        QuerySpec(4, duration * 0.6, None, "surveiledge")))
    speeds = tuple(1.0 if i % 2 == 0 else 0.5 for i in range(num_edges))
    # churn multiplies traffic (every live query scores every camera's
    # detections), so compute and the shedding gate are sized for the
    # multi-query peak — the point is lifecycle churn, not overload
    return Scenario(name="query_churn", edge_speeds=speeds,
                    num_cameras=num_cameras, duration_s=duration,
                    queries=queries, drift_at_s=drift_at,
                    edge_service_s=kw.pop("edge_service_s", 0.04),
                    offload_drain_s=kw.pop("offload_drain_s", 6.0),
                    train_step_s=kw.pop("train_step_s", duration / 1800.0),
                    update_period_s=kw.pop("update_period_s", None), **kw)


def rush_hour(num_cameras: int = 8, num_edges: int = 3, **kw) -> Scenario:
    """The serving control plane's acceptance workload: query submissions
    outpace the cloud's fine-tune throughput.

    With admission enabled (``admission_backlog_s``), fine-tunes SERIALIZE
    on the cloud, so a morning flood of submissions builds a training
    backlog.  The query book is three tenants across three priority tiers:

      tier 0 (``metro-pd``) — two queries onboarded in the opening act,
        before the backlog exists; backlog-exempt, highest Eq. 7 SLO
        weight.  The acceptance gate demands ZERO SLO breaches here.
      tier 1 (``retail``)   — four queries submitted as the rush begins;
        they tolerate the full backlog allowance, so the earliest ones
        train (late, with visible head-of-query latency) and the last one
        sheds once the backlog passes the tier-1 line.
      tier 2 (``hobby``)    — six best-effort queries flooding in on a
        starvation-rate token bucket: the first burns the only token and
        sheds on backlog (its allowance is HALF tier 1's), the rest shed
        on quota — overload sheds bottom-up, never by arrival order.

    One edge dies mid-rush (failover alerts on top of the admission
    alerts).  Everything is duration-relative so the smoke-sized run
    keeps the same shed/priority story as the full-length one."""
    duration = kw.pop("duration_s", 60.0)
    d = duration
    queries = kw.pop("queries", (
        QuerySpec(0, 0.0, None, "surveiledge", tenant="metro-pd", tier=0),
        QuerySpec(1, d * 0.04, None, "surveiledge",
                  tenant="metro-pd", tier=0),
        QuerySpec(2, d * 0.20, None, "surveiledge", tenant="retail", tier=1),
        QuerySpec(3, d * 0.24, None, "surveiledge", tenant="retail", tier=1),
        QuerySpec(4, d * 0.28, None, "surveiledge", tenant="retail", tier=1),
        QuerySpec(5, d * 0.32, None, "surveiledge", tenant="retail", tier=1),
        QuerySpec(6, d * 0.22, None, "surveiledge", tenant="hobby", tier=2),
        QuerySpec(7, d * 0.26, None, "surveiledge", tenant="hobby", tier=2),
        QuerySpec(8, d * 0.30, None, "surveiledge", tenant="hobby", tier=2),
        QuerySpec(9, d * 0.34, None, "surveiledge", tenant="hobby", tier=2),
        QuerySpec(10, d * 0.38, None, "surveiledge", tenant="hobby", tier=2),
        QuerySpec(11, d * 0.42, None, "surveiledge", tenant="hobby",
                  tier=2)))
    speeds = tuple(1.0 if i % 2 == 0 else 0.5 for i in range(num_edges))
    return Scenario(
        name="rush_hour", edge_speeds=speeds,
        num_cameras=num_cameras, duration_s=duration, queries=queries,
        tiers=kw.pop("tiers", (
            TierSpec(0, "platinum", slo_s=d * 0.25, weight=3.0),
            TierSpec(1, "standard", slo_s=d * 0.15, weight=0.5),
            TierSpec(2, "besteffort", slo_s=d * 0.15, weight=0.0))),
        tenants=kw.pop("tenants", (
            TenantSpec("metro-pd", rate=1.0, burst=2),
            TenantSpec("retail", rate=0.5, burst=2),
            TenantSpec("hobby", rate=1.0 / duration, burst=1))),
        # each surveiledge fine-tune costs 0.1*duration of cloud time, so
        # the tier-1/2 submission wave (one every 0.02-0.04*duration)
        # outruns training ~3x — the backlog the admission gate sheds on
        admission_backlog_s=kw.pop("admission_backlog_s", d * 0.15),
        train_step_s=kw.pop("train_step_s", duration / 400.0),
        cq_nbytes=kw.pop("cq_nbytes", 512 * 1024),
        # per-camera rate scaled so FLEET traffic per live query is fixed
        # (~2.4 det/s): the rush must stress ADMISSION, not saturate the
        # three edges outright — a saturated fleet breaches every tier and
        # proves nothing about priority
        burst_rate=kw.pop("burst_rate", 2.4 / num_cameras),
        alert_queue_depth=kw.pop("alert_queue_depth", 8),
        alert_threshold_drift=kw.pop("alert_threshold_drift", 0.15),
        failures=kw.pop("failures", ((d * 0.6, 1),)),
        **kw)


def vehicle_pursuit(num_cameras: int = 12, num_edges: int = 6,
                    **kw) -> Scenario:
    """Cross-camera pursuit: a handful of fast vehicles sweep a 12-camera
    chain spread over 6 edges — consecutive cameras live on DIFFERENT
    edges (camera j homes on edge j % 6 + 1), so every camera crossing is
    an edge crossing and the predictive hand-off carries the whole
    track-continuity story.

    The track query's targets move at 24-48 px/s through 128 px camera
    fields (~3-5 s dwell per camera, many crossings per run).  A crossing
    lands the target on an edge that has never seen it: cold, the
    similarity floor is ``track_thresholds[1]`` and only a same-camera
    continuation clears it — the track fragments (an ID switch).  With
    ``predictive_handoff`` the registry ships a pre-warm down the WAN the
    moment the previous crossing reveals the direction, the next edge
    accepts at the warm floor, and the track survives.  The committed
    report pairs the default row with a ``surveiledge_no_handoff``
    ablation so the gap is a gated number, not a story."""
    duration = kw.pop("duration_s", 60.0)
    queries = kw.pop("queries", (
        QuerySpec(0, 0.0, None, "surveiledge", kind="track"),))
    speeds = tuple(1.0 if i % 2 == 0 else 0.5 for i in range(num_edges))
    return Scenario(name="vehicle_pursuit", edge_speeds=speeds,
                    num_cameras=num_cameras, duration_s=duration,
                    queries=queries,
                    interval_s=kw.pop("interval_s", 0.5),
                    track_objects=kw.pop("track_objects", 3),
                    track_distractors=kw.pop("track_distractors", 1),
                    track_speed_px_s=kw.pop("track_speed_px_s",
                                            (24.0, 48.0)),
                    train_step_s=kw.pop("train_step_s", duration / 1800.0),
                    **kw)


def crowd_flow(num_cameras: int = 8, num_edges: int = 4, **kw) -> Scenario:
    """Dense pedestrian flow: many slow walkers (6-14 px/s — ~10-20 s
    dwell per camera) under one track query, with a classify query riding
    the same stream — the kinded API's mixed-workload scenario.  Crossings
    are rarer than ``vehicle_pursuit``'s but the track table is much
    bigger, so this preset stresses association breadth (every crop
    against every live track, still ONE fused launch per tick) where
    pursuit stresses hand-off timing."""
    duration = kw.pop("duration_s", 45.0)
    queries = kw.pop("queries", (
        QuerySpec(0, 0.0, None, "surveiledge", kind="track"),
        QuerySpec(1, 0.0, None, "no_finetune")))
    speeds = tuple(1.0 if i % 2 == 0 else 0.5 for i in range(num_edges))
    return Scenario(name="crowd_flow", edge_speeds=speeds,
                    num_cameras=num_cameras, duration_s=duration,
                    queries=queries,
                    interval_s=kw.pop("interval_s", 0.5),
                    track_objects=kw.pop("track_objects", 10),
                    track_distractors=kw.pop("track_distractors", 4),
                    track_speed_px_s=kw.pop("track_speed_px_s",
                                            (6.0, 14.0)),
                    track_ttl_s=kw.pop("track_ttl_s", 5.0),
                    train_step_s=kw.pop("train_step_s", duration / 1800.0),
                    **kw)


def pixel_city(num_cameras: int = 12, num_edges: int = 4, **kw) -> Scenario:
    """Pixel-path operating point: the frames->query loop at a size the
    pixel kernels run on a CPU inside the CI smoke budget.

    Run it with ``run_query(pixel_city(), frontend=PixelFrontend())``: every
    camera renders one frame triple per tick (staggered within the tick via
    ``frame_schedule``), the framediff/morphology cascade extracts
    motion crops, and the CQ classifier scores each tick's fleet-wide crop
    batch in one bucket-padded launch.  A mixed 1.0x/0.5x edge rack keeps
    Eq. 7 non-trivial without city_scale's fleet size."""
    duration = kw.pop("duration_s", 12.0)
    speeds = tuple(1.0 if i % 2 == 0 else 0.5 for i in range(num_edges))
    return Scenario(name="pixel_city", edge_speeds=speeds,
                    num_cameras=num_cameras, duration_s=duration, **kw)


SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "single_edge": single_edge,
    "homogeneous_multi_edge": homogeneous_multi_edge,
    "heterogeneous_multi_edge": heterogeneous_multi_edge,
    "bursty_crowds": bursty_crowds,
    "straggler_edge": straggler_edge,
    "city_scale": city_scale,
    "metropolis": metropolis,
    "drifting_city": drifting_city,
    "multi_query_city": multi_query_city,
    "query_churn": query_churn,
    "pixel_city": pixel_city,
    "rush_hour": rush_hour,
    "vehicle_pursuit": vehicle_pursuit,
    "crowd_flow": crowd_flow,
}
