"""WAN/LAN transport layer for the query pipeline.

Three link families, matching the paper's deployment: a *shared* WAN
uplink (edge -> cloud) modelled as one FIFO — concurrent uploads
serialize, which is what makes cloud-only saturate (Table II) — a shared
WAN **downlink** (cloud -> edge) over which recalibrated CQ parameters
ship back to the fleet (the cloud's egress serializes the same way), and
dedicated edge-to-edge LAN links that never contend.  ``Transport`` owns
all three plus the byte counters the ``QueryReport`` bandwidth columns are
built from.

Transfer *time* is accounted here too (``wan_transfer_s`` /
``lan_transfer_s`` / ``downlink_transfer_s``): a task's time on the wire
belongs to the link, never to the serving node's latency estimator —
feeding it there would let one congestion burst permanently inflate a
node's Eq. 7 ``t_j`` while ``wan_backlog`` *also* charges the same
congestion, double-counting it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.distributed import quantize as QZ
from repro_torch.serving.bus import FifoLink
from repro_torch.system.scenario import Scenario


class Transport:
    """The pipeline's only gateway onto the wire."""

    def __init__(self, sc: Scenario):
        self._uplink = FifoLink(sc.uplink_MBps, sc.rtt_s)
        self._downlink = FifoLink(sc.downlink_MBps, sc.rtt_s)
        self._lan_MBps = sc.lan_MBps
        self._rtt_s = sc.rtt_s
        self._quantize = sc.quantize_downlink
        self.uploaded_bytes = 0     # shipped over the shared WAN uplink
        self.downloaded_bytes = 0   # shipped over the WAN downlink (updates)
        self.downlink_fp_bytes = 0  # fp-equivalent downlink cost (reference)
        self.lan_bytes = 0          # shipped edge-to-edge
        self.wan_transfer_s = 0.0   # cumulative uplink seconds-on-the-wire
        self.downlink_transfer_s = 0.0
        self.lan_transfer_s = 0.0

    def wan_send(self, t: float, nbytes: int) -> float:
        """Start an upload at ``t``; returns delivery time (FIFO-serialized)."""
        self.uploaded_bytes += nbytes
        done = self._uplink.send(t, nbytes)
        self.wan_transfer_s += done - t
        return done

    def wan_recv(self, t: float, nbytes: int) -> float:
        """Cloud -> edge shipment at ``t`` (model updates); returns delivery
        time.  The downlink is its own shared FIFO: a fleet-wide parameter
        push serializes edge by edge, so later edges see staler data."""
        self.downloaded_bytes += nbytes
        done = self._downlink.send(t, nbytes)
        self.downlink_transfer_s += done - t
        return done

    def ship_update(self, t: float, fp_nbytes: int, values=None):
        """Ship one ModelUpdate artifact cloud -> edge at ``t``.

        Returns ``(delivery_time, values_as_delivered)``.  Under
        ``Scenario.quantize_downlink`` the link is charged the exact int8
        wire size (``quantize.quantized_wire_nbytes`` — values + per-channel
        scale/zero + framing) and any materialized ``values`` round-trip
        encode->decode, so the edge applies the parameters it actually
        received, quantization error included.  ``downlink_fp_bytes``
        always accumulates the full-width cost: it is the differential
        reference the report gate compares the charged bytes against."""
        self.downlink_fp_bytes += fp_nbytes
        if self._quantize:
            nbytes = QZ.quantized_wire_nbytes(fp_nbytes)
            if values is not None:
                values = QZ.decode_wire(QZ.encode_wire(np.asarray(values)))
        else:
            nbytes = fp_nbytes
        return self.wan_recv(t, nbytes), values

    def lan_send(self, t: float, nbytes: int) -> float:
        """Edge-to-edge transfer: dedicated link, non-contending."""
        self.lan_bytes += nbytes
        done = t + nbytes / (self._lan_MBps * 1e6) + self._rtt_s
        self.lan_transfer_s += done - t
        return done

    def wan_backlog(self, t: float) -> float:
        """Seconds of queued WAN transfers ahead of a new upload at ``t``.

        Eq. 7 charges this to the cloud's cost (the paper folds transmission
        latency into t_0), and Eqs. 8-9 fold it into the escalation drain.
        It is the *sole* congestion charge — completion times feed the node
        estimators net of transfer, so congestion is never counted twice."""
        return self._uplink.backlog(t)
