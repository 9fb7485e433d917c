#!/usr/bin/env python3
"""Split the fused pixel cascade's time into its phases, on the card.

  python3 tools/pixel_phases.py

Copies ``src/repro_torch/kernels/csrc/pixel_cascade.cu`` (and
``pixel.cuh``) into ``build/pixel_phases/`` with stamps at its ``//
PHASE(name)`` lines (``tools/phase_stamps.py``): thread 0 of every block
reads the SM clock (``clock64``) before each phase (the halo's copies and
the wait for them, framediff, the stencil, the count's atomic and the
mask stores, the wait for the atomic's ticket) and at the kernel's end,
and the global nanosecond timer (``%globaltimer``) at its start and end,
and writes them to a record a block.  Builds the copy with nvcc and runs
it, checked against the plain version, on pixel_city's tick
(``PIXEL_TICK``: uint8 camera views, and the same frames in int32) and at
``chip_smoke.HD`` (uint8 views and int32).  Prints one JSON line a case:
the stream ms per call (``chip_smoke.device_ms``, of the instrumented
copy) and that of a copy cut to its staging (``copies_only``: the halo's
reads and the barrier after them, no output written), the blocks, how far
apart the first and last block started and the first start and last end
lay (ns), the most blocks an SM ran at once, and each phase's mean and
largest SM cycles over the blocks.  The stamps cost a few instructions a
block.  Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import phase_stamps as PS

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "pixel_phases"
#: (B, H, W) of pixel_city's tick
PIXEL_TICK = (12, 96, 128)
#: the kernel's PHASE markers, in order; "end" closes the last phase
PHASES = ["staging", "framediff", "stencil", "atomic_and_stores",
          "ticket_wait"]
#: records of 8 int64 a block: global ns at start and end, the SM cycles
#: of each phase, and the block's SM
RECORD = 8
MAX_BLOCKS = 1 << 16
#: C lines at the first marker (the global timer) and at "end" (the record)
START = ("unsigned long long g_start;\n"
         'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start));')
END = "\n".join([
    "if (tid == 0) {",
    "  unsigned long long g_end;",
    '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_end));',
    "  long long* rec = phase_prof + 8 * ((blockIdx.z * gridDim.y +",
    "                                      blockIdx.y) * gridDim.x +",
    "                                     blockIdx.x);",
    "  unsigned smid;",
    '  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));',
    "  rec[0] = g_start;", "  rec[1] = g_end;", "  rec[7] = smid;",
    *(f"  rec[{2 + i}] = c{i + 1} - c{i};" for i in range(len(PHASES))),
    "}"])


def instrumented(src: str) -> str:
    """The kernel source with the stamps and the record pointer (the C
    signature stays as it is)."""
    src = PS.stamp(src, PHASES + ["end"], {PHASES[0]: START, "end": END})
    return PS.with_record_pointer(src, "pixel_cascade")


def copies_only(src: str) -> str:
    """The kernel cut to its staging: everything from the framediff on is
    taken out (its mask and counts are not written)."""
    return PS.cut(src, PHASES[1], "end")


def resident(recs) -> int:
    """The most blocks any SM ran at once, from the blocks' start and end
    times (a block counts from its first stamp to its last)."""
    most = 0
    for sm in recs[:, 7].unique():
        r = recs[recs[:, 7] == sm]
        events = sorted([(float(t), 1) for t in r[:, 0]] +
                        [(float(t), -1) for t in r[:, 1]])
        now = 0
        for _, step in events:
            now += step
            most = max(most, now)
    return most


def summary(torch, prof) -> dict:
    """The blocks' records (those written since ``prof`` was zeroed)."""
    recs = prof.view(-1, RECORD)
    recs = recs[recs[:, 0] != 0].double()
    if len(recs) > MAX_BLOCKS:
        sys.exit("pixel_phases: more blocks than records")
    out = {"blocks": len(recs),
           "start_spread_ns": float(recs[:, 0].max() - recs[:, 0].min()),
           "first_start_to_last_end_ns": float(recs[:, 1].max() -
                                               recs[:, 0].min()),
           "block_ns_mean": float((recs[:, 1] - recs[:, 0]).mean()),
           "resident_blocks_max": resident(recs)}
    for i, name in enumerate(PHASES):
        out[f"{name}_cycles_mean"] = float(recs[:, 2 + i].mean())
        out[f"{name}_cycles_max"] = float(recs[:, 2 + i].max())
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("pixel_phases: torch finds no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))

    import chip_smoke as CS
    from repro_torch.kernels import pixel_cascade as PC
    from repro_torch.kernels import runtime

    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "pixel.cuh", OUT / "pixel.cuh")
    source = (CSRC / "pixel_cascade.cu").read_text()
    lib = PS.build(runtime, OUT, "pixel_cascade_phases",
                   instrumented(source), "pixel_cascade", "pixel_phases")
    bare = PS.build(runtime, OUT, "pixel_cascade_copies_only",
                    copies_only(source), "pixel_cascade", "pixel_phases")
    dev = torch.device("cuda")
    prof = torch.zeros(MAX_BLOCKS * RECORD, dtype=torch.int64, device=dev)
    PS.set_records(lib, "pixel_cascade", prof, "pixel_phases")
    print(CS.card_line(), flush=True)
    g = torch.Generator(device="cpu").manual_seed(7)
    kw = dict(threshold=40, maxval=255)
    for shape in (PIXEL_TICK, CS.HD):
        views = CS.camera_views(torch, g, *shape, dev)
        for dtype in (torch.uint8, torch.int32):
            fs = views if dtype == torch.uint8 else \
                [v.to(torch.int32) for v in views]
            B, H, W = shape
            mask = torch.empty((B, H, W), dtype=torch.int32, device=dev)
            counts = torch.empty((B,), dtype=torch.int32, device=dev)
            acc = torch.zeros((B,), dtype=torch.int64, device=dev)

            def call(lib=lib):
                rc = lib.pixel_cascade_launch(
                    *(f.data_ptr() for f in fs), mask.data_ptr(),
                    counts.data_ptr(), acc.data_ptr(), B, H, W,
                    kw["threshold"], kw["maxval"], fs[0].element_size(),
                    *(f.stride(0) for f in fs), runtime.stream(dev))
                if rc != 0:
                    sys.exit(f"pixel_phases: launch failed ({rc})")
            call()
            want = PC.pixel_cascade_torch(*fs, **kw)
            if not (torch.equal(mask, want[0]) and
                    torch.equal(counts, want[1])):
                sys.exit(f"pixel_phases: differs at {shape} {dtype}")
            ms = CS.device_ms(torch, call, 100)
            copies_ms = CS.device_ms(torch, lambda: call(bare), 100)
            prof.zero_()
            call()
            torch.cuda.synchronize()
            print(json.dumps({"shape": list(shape), "dtype": str(dtype),
                              "ms": ms, "copies_only_ms": copies_ms,
                              **summary(torch, prof)}),
                  flush=True)


if __name__ == "__main__":
    main()
