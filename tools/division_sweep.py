#!/usr/bin/env python3
"""Hold the calibrate kernel's branch-free divisions against the ``/``
operator, bit for bit, on the card.

  python3 tools/division_sweep.py

Takes ``recip`` and ``quotient`` as they stand in
``src/repro_torch/kernels/csrc/calibrate.cu``, builds them into sweep
kernels with the kernels' nvcc flags (``build/division_sweep/``), and
counts the inputs where they differ from IEEE division (``__fdiv_rn``,
what ``/`` compiles to without fast-math flags), compared as floats: the
same bits, except that -0 equals +0 (no input here makes a NaN):

* ``recip(b)`` against ``1 / b`` for every float b in [1, 2^92), the
  range of the kernel's ``1 + exp(..)``;
* ``quotient(c, 1 - c)`` against ``c / (1 - c)`` for every float c in
  [1e-4, 1 - 1e-4], the logit feature's clipped scores;
* ``quotient(a, b)`` against ``a / b`` on 2^32 hashed pairs: a of either
  sign and of magnitude below 2^64 (zero and denormals included), b a
  normal float in [1e-4, 2^92], the Newton solve's divisor range.  Pairs
  that differ are counted by the operator's quotient (normal, or below
  2^-126: a denormal or an underflow to zero), and for those with a normal
  quotient the largest |a| among them is kept: the fast path's residual
  ``a - b q`` loses bits once it falls below 2^-126.

Prints the card's name and power limit and one JSON line of counts, and
exits 1 if any reciprocal or logit quotient differs: those two sweeps
cover every operand the kernel can give them.  Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import re
import struct
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "calibrate.cu"
OUT = ROOT / "build" / "division_sweep"
PAIRS = 1 << 32

SWEEP = r"""
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

%(functions)s

namespace {

__device__ __forceinline__ uint32_t mix(uint64_t x) {  // splitmix64
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return static_cast<uint32_t>((x ^ (x >> 31)) >> 32);
}

__device__ __forceinline__ uint64_t first() {
  return blockIdx.x * static_cast<uint64_t>(blockDim.x) + threadIdx.x;
}

__device__ __forceinline__ uint64_t stride() {
  return static_cast<uint64_t>(gridDim.x) * blockDim.x;
}

__device__ __forceinline__ bool differ(float x, float y) { return x != y; }

// the floats whose bit patterns lie in [lo, hi]: bad[0] += recip(b) != 1 / b
__global__ void sweep_recip(uint32_t lo, uint32_t hi,
                            unsigned long long* bad) {
  unsigned long long n = 0;
  for (uint64_t u = lo + first(); u <= hi; u += stride()) {
    const float b = __uint_as_float(static_cast<uint32_t>(u));
    n += differ(recip(b), __fdiv_rn(1.0f, b));
  }
  if (n) atomicAdd(bad, n);
}

// bad[1] += quotient(c, 1 - c) != c / (1 - c)
__global__ void sweep_logit(uint32_t lo, uint32_t hi,
                            unsigned long long* bad) {
  unsigned long long n = 0;
  for (uint64_t u = lo + first(); u <= hi; u += stride()) {
    const float c = __uint_as_float(static_cast<uint32_t>(u));
    n += differ(quotient(c, 1.0f - c), __fdiv_rn(c, 1.0f - c));
  }
  if (n) atomicAdd(bad + 1, n);
}

// hashed pairs: bad[2] += differ with a normal quotient, bad[3] += differ
// with a quotient below 2^-126, bad[4] = the largest |a| bits of bad[2]'s
__global__ void sweep_pairs(uint64_t pairs, uint32_t a_span, uint32_t b_lo,
                            uint32_t b_span, unsigned long long* bad) {
  unsigned long long normal = 0, tiny = 0, widest = 0;
  for (uint64_t i = first(); i < pairs; i += stride()) {
    const uint32_t ha = mix(2 * i), hb = mix(2 * i + 1);
    const float a = __uint_as_float((ha & 0x80000000u) |
                                    ((ha & 0x7fffffffu) %% a_span));
    const float b = __uint_as_float(b_lo + hb %% b_span);
    const float ref = __fdiv_rn(a, b);
    if (differ(quotient(a, b), ref)) {
      if (fabsf(ref) >= FLT_MIN) {
        ++normal;
        const unsigned long long mag = __float_as_uint(a) & 0x7fffffffu;
        widest = mag > widest ? mag : widest;
      } else {
        ++tiny;
      }
    }
  }
  if (normal) atomicAdd(bad + 2, normal);
  if (tiny) atomicAdd(bad + 3, tiny);
  if (widest) atomicMax(bad + 4, widest);
}

}  // namespace

extern "C" int sweep(uint32_t recip_lo, uint32_t recip_hi, uint32_t logit_lo,
                     uint32_t logit_hi, uint64_t pairs, uint32_t a_span,
                     uint32_t b_lo, uint32_t b_span, unsigned long long* out) {
  unsigned long long* bad = nullptr;
  cudaMalloc(&bad, 5 * sizeof(unsigned long long));
  cudaMemset(bad, 0, 5 * sizeof(unsigned long long));
  const int blocks = 132 * 8, threads = 256;
  sweep_recip<<<blocks, threads>>>(recip_lo, recip_hi, bad);
  sweep_logit<<<blocks, threads>>>(logit_lo, logit_hi, bad);
  sweep_pairs<<<blocks, threads>>>(pairs, a_span, b_lo, b_span, bad);
  cudaMemcpy(out, bad, 5 * sizeof(unsigned long long),
             cudaMemcpyDeviceToHost);
  cudaFree(bad);
  return static_cast<int>(cudaGetLastError());
}
"""


def functions(text: str) -> str:
    """The source of ``recip`` and ``quotient``, from the first's signature
    to the end of the second's body."""
    start = text.index("__device__ __forceinline__ float recip(")
    body = re.compile(r"__device__ __forceinline__ float quotient\(.*?\n}\n",
                      re.S).search(text, start)
    return text[start:body.end()]


def bits(x: float) -> int:
    """The bit pattern of x rounded to f32."""
    return struct.unpack("<I", struct.pack("<f", x))[0]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("division_sweep: torch finds no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as CS
    from repro_torch.kernels import runtime

    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / "division_sweep.cu", OUT / "division_sweep.so"
    cu.write_text(SWEEP % {"functions": functions(SOURCE.read_text())})
    subprocess.run([runtime.nvcc(), *runtime.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).sweep
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_uint32] * 4 + [ctypes.c_uint64] + \
        [ctypes.c_uint32] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_ulonglong * 5)()
    # 1 - EPS rounded once, as the kernel's kEpsHi
    rc = fn(bits(1.0), bits(2.0 ** 92) - 1, bits(1e-4), bits(1.0 - 1e-4),
            PAIRS, bits(2.0 ** 64), bits(1e-4),
            bits(2.0 ** 92) - bits(1e-4) + 1, ctypes.addressof(out))
    if rc != 0:
        sys.exit(f"division_sweep: cudaError {rc}")
    counts = {"recip_differ": out[0], "logit_quotient_differ": out[1],
              "pairs": PAIRS, "pairs_differ_normal_quotient": out[2],
              "pairs_differ_below_2^-126": out[3],
              "largest_dividend_differ_normal_quotient":
                  struct.unpack("<f", struct.pack("<I", out[4]))[0]}
    print(CS.card_line())
    print(json.dumps(counts), flush=True)
    if out[0] or out[1]:
        sys.exit(1)


if __name__ == "__main__":
    main()
