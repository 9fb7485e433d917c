"""int8 weights for serving, and the WAN wire format for cloud -> edge
model shipments.

Serving: symmetric int8 with per-output-channel scales.  Quantization is
meta-aware (``repro_torch.models.meta``): only weight leaves (init
normal, ndim >= 2) are quantized; norm scales and biases stay in float.
A quantized leaf is a ``{"q": int8, "s": f32 scales}`` dict.
Layer-stacked leaves keep their leading ``stack`` axis in the scale,
shape (L, out), so indexing ``params["layers"]`` by layer slices both
halves to an unstacked leaf.  ``transformer.maybe_dequant`` dequantizes
one layer's slice at a time inside the layer loop, so only one layer's
weights are ever resident in bf16.  ``abstract_quantized`` and
``quantized_shardings`` are the dry-run's shape-only tree and shardings
of that layout.

Wire: per-query CQ weights and recalibrated Platt heads ship
int8-quantized over the query pipeline's WAN downlink
(``system/transport.py``) instead of full-width fp32.  The wire format is
affine (scale + zero-point per channel): a Platt head's (a, b) ranges are
nowhere near symmetric around zero, and wasting half the int8 range on a
one-sided payload doubles the round-trip error for free.

Byte accounting is explicit and exact so ``Transport`` can charge the
*real* shipped size: 1 byte per value, 8 bytes (fp32 scale + fp32 zero)
per ``WIRE_CHANNEL``-value channel, plus a fixed framing header.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models import meta as M
from repro_torch.models.config import ModelConfig


def _is_quant(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def quantize_leaf(x: torch.Tensor, stacked: bool):
    """x (..., out) -> {"q": int8 like x, "s": (out,) or, ``stacked``,
    (L, out) f32}: one scale over every axis but the last (and, stacked,
    the leading layer axis), rounding half to even."""
    xf = x.to(torch.float32)
    axes = tuple(range(1 if stacked else 0, x.ndim - 1))
    amax = torch.amax(torch.abs(xf), dim=axes) if axes else torch.abs(xf)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    bshape = ((x.shape[0],) if stacked else ()) + (1,) * len(axes) + \
        (x.shape[-1],)
    q = torch.clamp(torch.round(xf / scale.reshape(bshape)), -127, 127)
    return {"q": q.to(torch.int8), "s": scale}


def dequantize_leaf(leaf, dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    q, s = leaf["q"], leaf["s"]
    if s.ndim == 2 and q.ndim >= 3 and s.shape[0] == q.shape[0]:
        s = s.reshape((q.shape[0],) + (1,) * (q.ndim - 2) + (q.shape[-1],))
    return (q.to(torch.float32) * s).to(dtype)


def _quantizable(pm: M.ParamMeta) -> bool:
    return pm.init in ("normal", "scaled") and len(pm.shape) >= 2


def quantize_tree(params: M.Tree, cfg: ModelConfig) -> M.Tree:
    """Quantize the weight leaves of ``params`` per ``cfg``'s metadata."""
    return M.tree_map(
        lambda pm, leaf: quantize_leaf(leaf, stacked=pm.axes[0] == M.STACK)
        if _quantizable(pm) else leaf, M.model_meta(cfg), params)


def dequant_tree(params: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Inverse of ``quantize_tree``, structure kept; float leaves pass."""
    if _is_quant(params):
        return dequantize_leaf(params, dtype)
    if isinstance(params, dict):
        return {k: dequant_tree(v, dtype) for k, v in params.items()}
    return params

def abstract_quantized(params_abs: M.Tree, cfg: ModelConfig) -> M.Tree:
    """The quantized layout of a shape-only parameter tree (``meta`` or
    fake tensors): int8 ``q`` of the leaf's shape beside f32 scales (out,)
    or, stacked, (L, out)."""
    def f(pm, leaf):
        if not _quantizable(pm):
            return leaf
        stacked = pm.axes[0] == M.STACK
        s = ((leaf.shape[0],) if stacked else ()) + (leaf.shape[-1],)
        return {"q": torch.empty(leaf.shape, dtype=torch.int8,
                                 device=leaf.device),
                "s": torch.empty(s, dtype=torch.float32, device=leaf.device)}
    return M.tree_map(f, M.model_meta(cfg), params_abs)


def quantized_shardings(pshard: M.Tree, params_abs: M.Tree,
                        cfg: ModelConfig, mesh) -> M.Tree:
    """Sharding tree matching ``abstract_quantized``: int8 values keep the
    original leaf's sharding; the small scale tensors are replicated."""
    from repro_torch.distributed.sharding import NamedSharding

    repl = NamedSharding(mesh, ())
    return M.tree_map(lambda pm, sh: {"q": sh, "s": repl}
                      if _quantizable(pm) else sh, M.model_meta(cfg), pshard)


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
