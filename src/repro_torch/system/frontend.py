"""Frontend seam: how detections enter the query pipeline.

A ``Frontend`` turns a scenario into the per-item detection stream the
event loop consumes.  Two implementations, as in the reference package:

- ``ConfidenceStreamFrontend`` — pre-scored confidences: either a
  model-free synthetic stream from the scenario's camera fleet or an
  injected pre-scored stream (the CQ-model-scored benchmark workload)
  re-homed onto the scenario's topology.
- ``PixelFrontend`` (``system/pixel_frontend.py``) — the paper's actual
  pixel path: rendered frames -> the fused pixel-cascade kernel (or the
  staged framediff/morphology kernels) -> moving object crops ->
  CQ-classifier confidences.

Frontends may record per-stage wall-clock seconds in ``self._timings``
while building the stream; ``run_query`` merges ``Frontend.timings`` into
``QueryReport.stage_timings`` next to the engine's own triage timing, so a
report shows where a frames-to-answers run actually spent its time.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.simulator import Item
from repro_torch.system.scenario import Scenario, synthetic_confidence_stream


def rehome(items: Sequence[Item], sc: Scenario) -> List[Item]:
    """Map a stream's edge ids onto ``sc``'s edges 1..E, sorted by arrival."""
    E = sc.num_edges
    stream = [dataclasses.replace(
        it, edge_device=(it.edge_device - 1) % E + 1)
        for it in items]
    stream.sort(key=lambda it: it.t_arrival)
    return stream


class Frontend(abc.ABC):
    """Produces the detection stream one scenario's run consumes."""

    def __init__(self):
        # per-instance so one frontend's stage timings can never bleed into
        # another's; subclasses fill this during stream()
        self._timings: Dict[str, float] = {}

    @abc.abstractmethod
    def stream(self, sc: Scenario) -> List[Item]:
        """Items sorted by arrival time, homed onto ``sc``'s edges."""

    @property
    def timings(self) -> Dict[str, float]:
        """Wall-clock seconds per frontend stage for the LAST ``stream()``
        call (empty for frontends with no model in the loop)."""
        return dict(self._timings)


class ConfidenceStreamFrontend(Frontend):
    """Pre-scored confidences: injected items, or a synthetic model-free
    stream (class-conditional Beta confidences) from the camera fleet."""

    def __init__(self, items: Optional[Sequence[Item]] = None):
        super().__init__()
        self._items = items

    def stream(self, sc: Scenario) -> List[Item]:
        if self._items is None:
            return synthetic_confidence_stream(sc)
        return rehome(self._items, sc)
