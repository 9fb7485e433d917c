"""The detection record the query system consumes.

The reference package's ``serving/simulator.py`` also holds the legacy
single-process ``CloudEdgeSim`` the paper-table benchmarks drive; it
arrives with the cloud-side training slice of the port.  The query
pipeline (``repro_torch.system``) needs only ``Item``, copied field for
field so a reference stream rebuilds here through
``repro_torch.bridge.items_from_records``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Item:
    """One detected object entering the query system."""
    t_arrival: float
    camera: int
    edge_device: int          # home edge of the camera
    conf: float               # edge-model confidence (precomputed)
    is_query: bool            # ground truth
    nbytes: int = 3 * 128 * 128  # crop payload (~49 KB, 128x128 RGB)
    query: int = 0            # which continuous query (CQ) scored this crop
    # cross-camera track queries (QuerySpec.kind == "track") only; both
    # default inert so every classify-path construction is unchanged
    emb: Optional[np.ndarray] = None   # L2-normalizable re-ID embedding
    gt_track: int = -1        # ground-truth trajectory id (-1: untracked)
