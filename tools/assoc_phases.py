#!/usr/bin/env python3
"""Split the association kernel's time into its phases, on the card.

  python3 tools/assoc_phases.py

Copies ``src/repro_torch/kernels/csrc/associate.cu`` into
``build/assoc_phases/`` with ``clock64()`` stamps added (thread 0 reads the
SM clock at the kernel's start, around each chunk's staging, after each
tile's score pass, after its candidate pass and after its claims; warp 0
counts the rows it rescans), builds it with nvcc, and runs it on random
problems (``chip_smoke.assoc_problem``) at ``SHAPES``, each with the
floors drawn at random and with every floor above 1 (no crop claims, so
no row is rescanned).  Prints one JSON line per case: the stream ms per
call (``chip_smoke.device_ms``) and the SM cycles of the whole kernel,
the staging and score passes (and the staging alone), the candidate
passes and the claims, and the rescans.  The stamps cost a few
instructions; the timed kernel is the instrumented copy.  Needs a CUDA
device; imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import phase_stamps as PS

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "associate.cu"
OUT = ROOT / "build" / "assoc_phases"
#: (M, K, D): the track presets' padded shapes, their largest, and a
#: problem of several row tiles
SHAPES = [(8, 8, 32), (16, 16, 32), (16, 64, 32), (128, 128, 32),
          (1024, 128, 32)]
#: (anchor in the kernel source, the part of it the text goes after, text)
STAMPS = [
    ("int track_chunk, int vec, int kp, int lg) {", "{",
     "\n  long long* prof = phase_prof;"
     "\n  long long t_score = 0, t_best = 0, t_claim = 0, t_stage = 0;"
     "\n  int rescans = 0;"
     "\n  const long long t_start = clock64();"
     "\n  long long t_tile = t_start, ta = 0, tb = 0, ts = 0;"),
    ("__syncthreads();  // the previous chunk's", "__syncthreads();",
     "\n        ts = clock64();"),
    ("__syncthreads();\n        if (kcn <= 32)", "__syncthreads();",
     "\n        t_stage += clock64() - ts;"),
    ("__syncthreads();\n    // each row's best and runner-up",
     "__syncthreads();",
     "\n    ta = clock64();\n    t_score += ta - t_tile;"),
    ("__syncthreads();\n    // 3. the greedy claims", "__syncthreads();",
     "\n    tb = clock64();\n    t_best += tb - ta;"),
    ("rescan(score + static_cast<size_t>(r) * kp, claimed, k, v, j);", ";",
     "\n              ++rescans;"),
    ("          sim[i0 + rb + lane] = out_s;\n        }\n      }\n    }",
     "}\n    }",
     "\n    t_tile = clock64();\n    t_claim += t_tile - tb;"),
]
#: text inserted before the kernel's closing brace
EPILOGUE = ("  if (tid == 0) {\n    prof[0] = clock64() - t_start;\n"
            "    prof[1] = t_score;\n    prof[2] = t_best;\n"
            "    prof[3] = t_claim;\n    prof[4] = rescans;\n"
            "    prof[5] = t_stage;\n  }\n")


def instrumented(src: str) -> str:
    """The kernel source with the stamps, and a ``__device__`` pointer the
    host sets to the cycle buffer (the C signature stays as it is)."""
    for anchor, part, text in STAMPS:
        at = src.index(anchor) + anchor.rindex(part) + len(part)
        src = src[:at] + text + src[at:]
    end = src.index("\n}\n\n}  // namespace")
    src = src[:end + 1] + EPILOGUE + src[end + 1:]
    src = src.replace("  if (k == 0) {  // nothing to match\n",
                      "  if (k == 0) {  // nothing to match\n"
                      "    if (tid == 0) prof[0] = 0;\n", 1)
    return PS.with_record_pointer(src, "associate")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("assoc_phases: torch finds no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels import runtime
    from repro_torch.kernels import similarity as SIM

    OUT.mkdir(parents=True, exist_ok=True)
    lib = PS.build(runtime, OUT, "associate_phases",
                   instrumented(SOURCE.read_text()), "associate",
                   "assoc_phases")
    dev = torch.device("cuda")
    prof = torch.zeros(8, dtype=torch.int64, device=dev)
    PS.set_records(lib, "associate", prof, "assoc_phases")
    print(CS.card_line(), flush=True)
    g = torch.Generator(device="cpu").manual_seed(5)
    for m, k, d in SHAPES:
        base = [t.to(dev) for t in CS.assoc_problem(torch, F, g, m, k, d)]
        for floors in ("random", "above_one"):
            ins = list(base)
            if floors == "above_one":
                ins[4] = torch.full_like(ins[4], 2.0)
            a = torch.empty(m, dtype=torch.int32, device=dev)
            s = torch.empty(m, dtype=torch.float32, device=dev)

            def call():
                rc = lib.associate_launch(
                    *(t.data_ptr() for t in ins), a.data_ptr(),
                    s.data_ptr(), m, k, d, runtime.stream(dev))
                if rc != 0:
                    sys.exit(f"assoc_phases: launch failed ({rc})")
            call()
            want = SIM.associate_torch(*ins)
            if not torch.equal(a, want[0]):
                sys.exit(f"assoc_phases: assign differs at {(m, k, d)}")
            ms = CS.device_ms(torch, call, 200)
            total, score, best, claims, rescans, stage = prof.tolist()[:6]
            print(json.dumps({"shape": [m, k, d], "floors": floors,
                              "ms": ms, "cycles": total,
                              "stage_and_score_cycles": score,
                              "of_which_staging_cycles": stage,
                              "candidate_cycles": best,
                              "claim_cycles": claims, "rescans": rescans}),
                  flush=True)


if __name__ == "__main__":
    main()
