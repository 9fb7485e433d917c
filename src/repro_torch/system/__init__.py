"""End-to-end multi-camera cloud-edge query system on PyTorch/CUDA.

``run_query(scenario, device="cuda")`` wires a ``Frontend`` (the
confidence stream, or the pixel path: ONE fused pixel-cascade kernel
launch and one CQ-classifier call per tick) -> ONE fused fleet-triage
kernel launch per tick (per-(query, edge) adaptive thresholds) -> Eq. 7
allocator -> per-node queues -> metrics, with the cloud->edge feedback
loop's ONE fused calibration launch per update period.  The layers and
presets are the reference package's (``events`` / ``transport`` /
``nodes`` / ``triage`` / ``feedback`` / ``frontend`` /
``pixel_frontend`` behind a slim ``pipeline`` orchestrator);
``SCENARIOS`` keeps every preset so names resolve, and ``run_query``
refuses with ``NotImplementedError`` the ones whose stages come in later
slices (``metropolis``: scan supersteps; ``vehicle_pursuit``,
``crowd_flow``: track queries).
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

#: the presets this slice of the port runs end to end (the others need a
#: stage that comes in a later slice and raise NotImplementedError)
PORTED_SCENARIOS = (
    "single_edge", "homogeneous_multi_edge", "heterogeneous_multi_edge",
    "bursty_crowds", "straggler_edge", "city_scale", "drifting_city",
    "multi_query_city", "query_churn", "rush_hour", "pixel_city")

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
