#!/usr/bin/env python3
"""Check and time the triage, calibrate, association, superstep and pixel
kernels of one source tree, and the card's launch floor.

  python3 tools/kernel_ab.py [--src DIR] [--tag NAME]

Builds ``csrc/{triage,calibrate,associate,superstep,pixel_cascade,
morphology,framediff}.cu`` of the ``repro_torch`` package under ``DIR``
(default: this checkout's ``src``) with nvcc, holds each against its plain
version with ``chip_smoke.py``'s checks (triage exactly at every
``TRIAGE_WIDTHS`` x ``TRIAGE_ROWS``, calibrate within ``CAL_ATOL`` at
``CALIBRATE_WIDTHS``, the superstep bit for bit at ``SUPERSTEP_SHAPES``,
the association at ``ASSOC_SHAPES`` and its semantic cases; the pixel
cascade, framediff and both morphology bindings exactly on int32 frames
at ``PIXEL_SHAPES``, ``PIXEL_TILE_SHAPES`` and ``HD``, and
``ops.pixel_cascade`` on uint8 camera views, which any tree takes; on a
tree whose cascade reads uint8 frames, all of ``chip_smoke.check_pixel``),
times each kernel at the main paths' shapes (``TRIAGE_TIMED``,
``CALIBRATE_TIMED``, ``ASSOC_TIMED``, ``SUPERSTEP_TIMED``; the cascade at
``PIXEL_TIMED`` and ``HD``: int32 frames, uint8 camera views (null on a
tree that refuses them), the tick as ``ops.pixel_cascade`` makes it from
the views, and the views widened to int32 first with a zeroed count
vector, as the tick was made before the cascade read uint8; framediff
and the dilate at both shapes; stream ms per call, as
``chip_smoke.device_ms``) and the empty kernel of ``csrc/triage.cu``
where the tree has one (null otherwise), and prints the card's name and
power limit and then one JSON line.  To compare two trees on one card,
run it in one session on each in turns (A, B, B, A).  Needs a CUDA
device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (R, N): city_scale's (64, 32) and (64, 64), drifting_city's (8, 16..64),
#: and the one-row launch at its bucket
TRIAGE_TIMED = [(64, 64), (64, 32), (8, 64), (8, 32), (8, 16), (1, 16)]
#: (R, N): drifting_city's (8, 16) and (8, 64), the feedback window's
#: full width, and the block path past it
CALIBRATE_TIMED = [(8, 16), (8, 64), (8, 256), (8, 1024)]
#: (M, K, D): the track presets' padded shapes and two larger problems
ASSOC_TIMED = [(8, 8, 32), (16, 16, 32), (16, 64, 32), (32, 128, 32),
               (128, 128, 32), (1024, 128, 32)]
#: (S, R, N): metropolis's slab shapes and the cap slab at other widths
SUPERSTEP_TIMED = [(1, 16384, 8), (9, 2048, 8), (64, 8192, 8),
                   (32, 16384, 8), (32, 16384, 3), (32, 16384, 16),
                   (32, 16384, 32), (32, 8192, 64)]
#: (B, H, W): pixel_city's tick (12 cameras of 96 x 128)
PIXEL_TIMED = (12, 96, 128)


def check_pixel_tree(torch, CS, FD, MO, PC, ops, dev) -> None:
    """The pixel kernels against their plain versions on what every tree
    takes; all of ``CS.check_pixel`` where the cascade reads uint8."""
    if hasattr(PC, "FRAME_DTYPES"):
        CS.check_pixel(torch, FD, MO, PC, ops, dev)
        return
    g = torch.Generator(device="cpu").manual_seed(0)
    kw = dict(threshold=40, maxval=255)
    for shape in CS.PIXEL_SHAPES + CS.PIXEL_TILE_SHAPES + [CS.HD]:
        fs = [f.to(dev) for f in CS.pixel_frames(torch, g, *shape)]
        pairs = [(PC.pixel_cascade(*fs, **kw),
                  PC.pixel_cascade_torch(*fs, **kw))]
        fd = FD.framediff(*fs, **kw)
        pairs.append(((fd,), (FD.framediff_torch(*fs, **kw),)))
        for op, fill in (("max", 0), ("min", 255)):
            pairs.append(((MO.morph3x3(fd, op=op, fill=fill),),
                          (MO.morph3x3_torch(fd, op=op, fill=fill),)))
        views = CS.camera_views(torch, g, *shape, dev)
        pairs.append((ops.pixel_cascade(*views, device=dev),
                       PC.pixel_cascade_torch(
                           *(v.to(torch.int32) for v in views), **kw)))
        for got, want in pairs:
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                CS.fail(f"a pixel kernel differs from its plain version at "
                        f"{shape}")


def time_pixel(torch, CS, FD, MO, PC, ops, dev, floor) -> list:
    """Stream ms per call of the pixel rows at ``PIXEL_TIMED`` and
    ``CS.HD``, each with its bytes bound and its share of it."""
    g = torch.Generator(device="cpu").manual_seed(6)
    kw = dict(threshold=40, maxval=255)
    reads_uint8 = hasattr(PC, "FRAME_DTYPES")
    rows = []

    def row(name, shape, fn, bound_name, dtype):
        ms = CS.device_ms(torch, fn, 100)
        bound = CS.pixel_bound_ms(bound_name, shape, dtype)[0]
        rows.append({"name": name, "shape": list(shape), "ms": ms,
                     "bound_ms": bound, "share_of_bound": bound / ms,
                     "over_floor_ms": None if floor is None else ms - floor})

    for shape in (PIXEL_TIMED, CS.HD):
        views = CS.camera_views(torch, g, *shape, dev)
        wide = [v.to(torch.int32) for v in views]
        u8 = torch.uint8
        row("cascade int32", shape, lambda: PC.pixel_cascade(*wide, **kw),
            "pixel_cascade", torch.int32)
        if reads_uint8:
            row("cascade uint8 views", shape,
                lambda: PC.pixel_cascade(*views, **kw), "pixel_cascade", u8)
        else:
            rows.append({"name": "cascade uint8 views", "shape": list(shape),
                         "ms": None})
        row("tick: ops.pixel_cascade on uint8 views", shape,
            lambda: ops.pixel_cascade(*views, device=dev), "pixel_cascade",
            u8)

        def widened_first():
            w = [v.to(torch.int32) for v in views]
            if reads_uint8:   # the older kernel zeroes its counts itself
                torch.zeros((shape[0],), dtype=torch.int32, device=dev)
            return PC.pixel_cascade(*w, **kw)
        row("widened first: 3 widening copies, zeroed counts, kernel",
            shape, widened_first, "pixel_cascade", u8)
        fd = FD.framediff(*wide, **kw)
        row("framediff", shape, lambda: FD.framediff(*wide, **kw),
            "framediff", None)
        row("morph3x3 dilate", shape,
            lambda: MO.morph3x3(fd, op="max", fill=0), "morph3x3", None)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: torch finds no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels import calibrate as C
    from repro_torch.kernels import framediff as FD
    from repro_torch.kernels import morphology as MO
    from repro_torch.kernels import ops, runtime
    from repro_torch.kernels import pixel_cascade as PC
    from repro_torch.kernels import similarity as SIM
    from repro_torch.kernels import superstep as SS
    from repro_torch.kernels import triage as T

    built = runtime.build(("triage", "calibrate", "associate", "superstep",
                           "pixel_cascade", "morphology", "framediff"))
    for name, info in sorted(built.items()):
        print(f"-- {name} ({args.tag}): {info['path']}\n"
              f"{info['log'].strip()}", flush=True)
    dev = torch.device("cuda")
    CS.check_triage(torch, T, ops, dev)
    CS.check_calibrate(torch, C, dev)
    CS.check_superstep(torch, SS, dev)
    CS.check_associate(torch, F, SIM, ops, dev)
    check_pixel_tree(torch, CS, FD, MO, PC, ops, dev)
    torch.cuda.synchronize()

    floor = (CS.device_ms(torch, lambda: T.empty_launch(dev), 200)
             if hasattr(T, "empty_launch") else None)
    g = torch.Generator(device="cpu").manual_seed(5)
    triage = []
    for r, n in TRIAGE_TIMED:
        conf = torch.rand((r, n), generator=g).to(dev)
        thr = torch.tensor([[0.7, 0.2]]).expand(r, 2).contiguous().to(dev)
        ms = CS.device_ms(torch, lambda: T.triage_fleet(conf, thr,
                                                        capacity=8), 200)
        triage.append({"shape": [r, n], "ms": ms,
                       "bound_ms": CS.triage_bound_ms(r, n)[0]})
    calibrate = []
    for r, n in CALIBRATE_TIMED:
        scores, truths = (t.to(dev) for t in CS.label_rows(torch, r, n, n))
        ms = CS.device_ms(torch, lambda: C.calibrate_fleet(
            scores, truths, iters=8, min_count=8), 200)
        calibrate.append({"shape": [r, n], "ms": ms,
                          "bound_ms": CS.calibrate_bound_ms(r, n, 8)[0]})
    for row in triage + calibrate:
        row["over_floor_ms"] = None if floor is None else row["ms"] - floor
    assoc = []
    for m, k, d in ASSOC_TIMED:
        ins = [t.to(dev) for t in CS.assoc_problem(torch, F, g, m, k, d)]
        assoc.append({"shape": [m, k, d],
                      "ms": CS.device_ms(torch, lambda: SIM.associate(*ins),
                                         200),
                      "bound_ms": CS.associate_bound_ms(m, k, d)[0]})
    steps = []
    for s, r, n in SUPERSTEP_TIMED:
        ins = [t.to(dev) for t in CS.superstep_slab(torch, g, s, r, n)]
        ms = CS.device_ms(torch, lambda: SS.superstep(*ins, capacity=8), 100)
        bound = CS.superstep_bound_ms(s, r, n)[0]
        steps.append({"shape": [s, r, n], "ms": ms, "bound_ms": bound,
                      "share_of_bound": bound / ms})
    pixel = time_pixel(torch, CS, FD, MO, PC, ops, dev, floor)
    print(CS.card_line())
    print(json.dumps({"tag": args.tag, "src": args.src,
                      "launch_floor_ms": floor, "triage": triage,
                      "calibrate": calibrate, "associate": assoc,
                      "superstep": steps, "pixel": pixel}), flush=True)


if __name__ == "__main__":
    main()
