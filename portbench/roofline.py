"""The card's peaks and each kernel's least time from its shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 495 TFLOP/s in TF32, the highest rate at which float32-accurate
products can run (3xTF32 and split-bf16 schemes stay under it), and
3.35 TB/s of HBM.  A kernel's bound is the larger of its algorithm's
operations over the peak and its bytes over the bandwidth: each input
byte read once, each output byte written once, operations counted once
whatever the implementation repeats.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

TF32_FLOP_S = 495e12
HBM_BYTES_S = 3.35e12


def flash_attention(B: int, H: int, KV: int, Sq: int, Sk: int, hd: int,
                    causal: bool = True, elem_bytes: int = 4
                    ) -> Tuple[float, float]:
    """(operations, bytes) of one attention launch: q (B, H, Sq, hd), k
    and v (B, KV, Sk, hd), o like q; a causal pass scores each query
    against the keys at or before it (top-left aligned)."""
    if causal:
        pairs = sum(min(i + 1, Sk) for i in range(Sq)) if Sq != Sk \
            else Sq * (Sq + 1) // 2
    else:
        pairs = Sq * Sk
    ops = 4.0 * B * H * hd * pairs
    nbytes = elem_bytes * (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd)
    return ops, float(nbytes)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time of a launch: the larger of its two terms."""
    return max(ops / TF32_FLOP_S, nbytes / HBM_BYTES_S)


#: every kernel with a roofline metric, by the name its metric carries
KERNELS: Dict[str, Callable[..., Tuple[float, float]]] = {
    "flash": flash_attention,
}
