"""WAN wire format for cloud -> edge model shipments (numpy only).

Per-query CQ weights and recalibrated Platt heads ship int8-quantized over
the query pipeline's WAN downlink (``system/transport.py``) instead of
full-width fp32.  The wire format is affine (scale + zero-point per
channel): a Platt head's (a, b) ranges are nowhere near symmetric around
zero, and wasting half the int8 range on a one-sided payload doubles the
round-trip error for free.

Byte accounting is explicit and exact so ``Transport`` can charge the
*real* shipped size: 1 byte per value, 8 bytes (fp32 scale + fp32 zero)
per ``WIRE_CHANNEL``-value channel, plus a fixed framing header.

The reference package's module also quantizes a whole model tree to int8
for serving; that half arrives with the LLM/serving slice of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: framing per shipped tensor: dtype tag, ndim/shape, channel count
WIRE_HEADER_NBYTES = 16
#: values per quantization channel used for byte accounting of artifacts
#: the simulator never materializes (a CQ head shipped as ``cq_nbytes``)
WIRE_CHANNEL = 256


@dataclasses.dataclass(frozen=True)
class WireTensor:
    """One int8-quantized payload as it crosses the WAN.

    ``q`` keeps the original shape; ``scale``/``zero`` are per-channel
    (the leading dim for >=2-D payloads, one channel for vectors).
    Dequantization is ``q * scale + zero``; the round-trip error is
    bounded by ``scale / 2`` per element (no clipping error: the affine
    grid is fitted to the channel's exact [min, max])."""
    q: np.ndarray        # int8, original payload shape
    scale: np.ndarray    # (channels,) float32
    zero: np.ndarray     # (channels,) float32

    @property
    def nbytes(self) -> int:
        """Exact on-the-wire size: values + per-channel (scale, zero) +
        framing header."""
        return WIRE_HEADER_NBYTES + self.q.size + 8 * self.scale.size


def encode_wire(x: np.ndarray) -> WireTensor:
    """Affine int8 quantization of a float payload for WAN shipping.

    Channels are rows of the leading dim (>=2-D) or the whole vector
    (1-D).  ``scale = (max - min) / 254`` and ``zero = (max + min) / 2``
    put the channel's range exactly on the [-127, 127] grid, so nothing
    clips and a constant channel round-trips bit-exactly."""
    x = np.asarray(x, np.float32)
    rows = x.reshape(x.shape[0] if x.ndim >= 2 else 1, -1)
    lo = rows.min(axis=1)
    hi = rows.max(axis=1)
    zero = (hi + lo) / 2.0
    scale = np.maximum((hi - lo) / 254.0, 1e-12)
    q = np.clip(np.round((rows - zero[:, None]) / scale[:, None]),
                -127, 127).astype(np.int8)
    return WireTensor(q=q.reshape(x.shape), scale=scale.astype(np.float32),
                      zero=zero.astype(np.float32))


def decode_wire(p: WireTensor) -> np.ndarray:
    """Inverse of ``encode_wire`` (lossy: within scale/2 per element)."""
    rows = p.q.reshape(p.scale.size, -1).astype(np.float32)
    out = rows * p.scale[:, None] + p.zero[:, None]
    return out.reshape(p.q.shape).astype(np.float32)


def quantized_wire_nbytes(fp_nbytes: int) -> int:
    """Downlink byte cost of shipping an fp32 artifact of ``fp_nbytes``
    int8-quantized: one byte per value plus the per-``WIRE_CHANNEL``
    (scale, zero) overhead plus framing — the *real* charged size, so the
    bandwidth reduction a report shows is ~3.9x, never a free 4x."""
    if fp_nbytes < 0:
        raise ValueError(f"fp_nbytes={fp_nbytes} must be >= 0")
    n = max(1, fp_nbytes // 4)
    channels = -(-n // WIRE_CHANNEL)
    return WIRE_HEADER_NBYTES + n + 8 * channels
