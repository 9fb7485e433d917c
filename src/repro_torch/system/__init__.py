"""End-to-end multi-camera cloud-edge query system on PyTorch/CUDA.

``run_query(scenario, device="cuda")`` wires a ``Frontend`` (the
confidence stream, or the pixel path: ONE fused pixel-cascade kernel
launch and one CQ-classifier call per tick) -> ONE fused fleet-triage
kernel launch per tick (per-(query, edge) adaptive thresholds), or ONE
scan-superstep launch per boundary-free run of ticks -> Eq. 7 allocator
-> per-node queues -> metrics, with the cloud->edge feedback loop's ONE
fused calibration launch per update period and, for track queries, ONE
fused association launch per tick.  The layers and presets are the
reference package's (``events`` / ``transport`` / ``nodes`` / ``triage``
/ ``superstep`` / ``tracks`` / ``feedback`` / ``frontend`` /
``pixel_frontend`` behind a slim ``pipeline`` orchestrator), driven by
``SimDriver`` or ``serving.engine.AsyncDriver``.
"""
from repro_torch.system.feedback import FeedbackStage, apply_calibration
from repro_torch.system.frontend import ConfidenceStreamFrontend, Frontend
from repro_torch.system.metrics import QueryReport, StreamingWindows
from repro_torch.system.pipeline import QueryPipeline, SimDriver, run_query
from repro_torch.system.pixel_frontend import PixelFrontend
from repro_torch.system.queries import DEFAULT_QUERY, QuerySet, QuerySpec
from repro_torch.system.scenario import (
    SCENARIOS,
    SCHEMES,
    Scenario,
    bursty_crowds,
    city_scale,
    crowd_flow,
    drifting_city,
    frame_schedule,
    heterogeneous_multi_edge,
    homogeneous_multi_edge,
    metropolis,
    multi_query_city,
    pixel_city,
    query_churn,
    rush_hour,
    scenario_cameras,
    single_edge,
    straggler_edge,
    synthetic_confidence_stream,
    vehicle_pursuit,
)

#: the presets the port runs end to end: every preset of the reference
PORTED_SCENARIOS = tuple(SCENARIOS)

__all__ = [
    "ConfidenceStreamFrontend",
    "DEFAULT_QUERY",
    "FeedbackStage",
    "Frontend",
    "PORTED_SCENARIOS",
    "PixelFrontend",
    "QueryPipeline",
    "QueryReport",
    "QuerySet",
    "QuerySpec",
    "SCENARIOS",
    "SCHEMES",
    "Scenario",
    "SimDriver",
    "StreamingWindows",
    "apply_calibration",
    "bursty_crowds",
    "city_scale",
    "crowd_flow",
    "drifting_city",
    "frame_schedule",
    "heterogeneous_multi_edge",
    "homogeneous_multi_edge",
    "metropolis",
    "multi_query_city",
    "pixel_city",
    "query_churn",
    "run_query",
    "rush_hour",
    "scenario_cameras",
    "single_edge",
    "straggler_edge",
    "synthetic_confidence_stream",
    "vehicle_pursuit",
]
