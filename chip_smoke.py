#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``) and the torch/CUDA
   versions;
2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   (all sources at once) and print ptxas's register/shared-memory report;
3. hold each kernel against its plain PyTorch version on the card at
   fixed edge-case shapes: triage (3D Q=3 fold, one row, capacity
   overflow, all-pad rows, NaN lanes, 2^17 rows) must agree exactly, the
   Platt fit (R in {4, 64} x N=256 with degenerate rows) within
   ``CAL_ATOL`` with exact counts; the pixel cascade, framediff, dilate
   and erode exactly, at ``PIXEL_SHAPES``, on sparse motion, on a static
   scene and at 1080p (``HD``), with the fused cascade also held against
   the staged framediff -> dilate -> erode launches; the scan superstep
   bit for bit (routes, slots and f32 thresholds) at ``SUPERSTEP_SHAPES``
   — the metropolis cap slab among them — with masks all off and all on,
   drains on both sides of the interval and capacity overflow; the track
   association at the reference test's shapes, K = 0, an all-masked query
   and a tie, ``assign`` exactly and ``sim`` within ``SIM_ATOL``;
4. the main path: ``run_query(city_scale(), device="cuda")`` at full size
   (64 edges, 512 cameras, 60 s) with the launch counters zeroed just
   before and read just after; the same run with ``device="cpu"`` must
   give the identical summary, and the triage launches must equal the
   run's ``kernel_launches``;
5. the feedback path: ``drifting_city(num_cameras=8, duration_s=60)`` on
   the card — calibrate launches must equal ``model_updates`` (> 0), the
   closed loop's F2 must beat the ``update_period_s=None`` ablation, and
   the summary must equal the same run's with ``device="cpu"``, or differ
   only in keys that lie within their ``GATE_BANDS``;
6. the pixel path: ``run_query(pixel_city(), frontend=PixelFrontend(seed=0,
   device="cuda"), device="cuda")`` at the preset's full size (12
   cameras, 4 edges, 12 s) — one pixel-cascade launch per tick, one
   classifier batch per tick with crops; the same run with
   ``device="cpu"`` must give the same stream (``conf`` within
   ``CONF_ATOL``) and the same summary, or differ only within
   ``GATE_BANDS``; ``PixelFrontend(fused=False)`` on the card must give
   the identical stream from one framediff and two morphology launches a
   tick.  Prints the render / framediff / CCL / classify split of the
   card's run, of a second card run and of the host's;
7. the superstep path: ``run_query(metropolis(duration_s=METRO_S))`` at the
   preset's full fleet (10,240 cameras, 1,024 edges, 24 queries, 10 Hz):
   superstep launches must equal ``supersteps`` and each must fuse >= 10
   triaged ticks on average; at the smoke size (1,024 cameras, 12 s) the
   card's report must equal the CPU's, and ``superstep=1`` must be
   bit-identical to the preset's ``superstep=128``;
8. the track path: ``vehicle_pursuit()`` and ``crowd_flow()`` on the card:
   one associate launch per tick with crops and a live table, summaries
   equal to the CPU's, fewer ID switches than the ``predictive_handoff=
   False`` ablation, and ``AsyncDriver(VirtualClock())`` identical to
   ``SimDriver`` on ``vehicle_pursuit``;
9. time each kernel and its plain version on the inputs the main paths
   gave it (the pixel kernels also at 1080p), and print
   ``{"kernels": [...]}`` (per kernel: launches per path, max error
   against the plain version, kernel/plain ms with the stream pre-loaded,
   the bound from the bytes and operations of the timed inputs, and the
   one PyTorch call that computes the same function, where there is
   one), then, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, where torch finds no CUDA device or
the port's sources are not beside this script.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
#: tensor cores — the two rates a bound is taken against
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12  # also taken as the scalar integer rate
#: params tolerance, kernel vs plain version on the card: both are f32
#: Newton fits of one function, but the kernel sums in a tree of warp
#: shuffles and contracts multiply-adds, and 8 Newton steps carry those
#: ulps forward
CAL_ATOL = 1e-4
#: summary key -> (kind, band, floor of a relative band): the bands of
#: ``benchmarks/report_gate.py`` for the keys a ``drifting_city`` summary
#: carries, copied so that this script reads nothing of the reference
GATE_BANDS = {
    "accuracy_F2": ("abs", 0.05, 0.0),
    "avg_latency_s": ("rel", 0.25, 0.05),
    "p99_latency_s": ("rel", 0.25, 0.10),
    "bandwidth_MB": ("rel", 0.25, 0.05),
    "lan_MB": ("rel", 0.25, 0.05),
    "downloaded_MB": ("rel", 0.25, 0.05),
    "downlink_fp_MB": ("rel", 0.25, 0.05),
    "uplink_bytes_per_TP": ("rel", 0.25, 256.0),
    "reconciliation_flip_rate": ("abs", 0.05, 0.0),
    "provisional_latency_s": ("rel", 0.25, 0.05),
}
#: confidence tolerance, card vs host on the pixel path: the CQ classifier
#: runs in f32 on both (TF32 off), its matmul and softmax sums in another
#: order
CONF_ATOL = 1e-5
#: (B, H, W) of ``tests/test_pixel_cascade.py``'s fixed cases: the default
#: camera frame, a sub-band height, non-lane widths
PIXEL_SHAPES = [(2, 96, 128), (1, 33, 40), (3, 16, 300), (2, 100, 96),
                (1, 64, 129)]
#: eight 1080p cameras: ~0.6 GB of int32 frames a tick
HD = (8, 1080, 1920)
#: bytes a pixel each pixel kernel must move: three (.., 3) int32 pixels
#: read and one int32 mask value written; morphology reads and writes one
PIXEL_BYTES = {"pixel_cascade": 3 * 12 + 4, "framediff": 3 * 12 + 4,
               "morph3x3": 4 + 4}
#: integer operations a pixel: framediff's 3 x (2 sub, 2 abs, and) + gray
#: (3 mul, 2 add, div) + compare; a 3x3 stencil's 9 compares; the cascade
#: does both stencils
PIXEL_OPS = {"pixel_cascade": 22 + 18, "framediff": 22, "morph3x3": 9}
#: a pending kernel that holds the stream while the host enqueues a timed
#: loop, so the events time the device, not the Python launch path
HOLD_CYCLES = 500_000_000
#: sim tolerance, association kernel vs plain version: the same f32 dots,
#: a chain of FMAs on the card and a matmul in the plain version
#: (``tests/test_track_query.py``'s tolerance)
SIM_ATOL = 1e-5
#: (S, R, N) superstep slabs: one row, metropolis's smallest and largest
#: smoke-size slabs, the cap slab (``MAX_SUPERSTEP_ELEMS``), an odd S
SUPERSTEP_SHAPES = [(1, 1, 8), (2, 16, 8), (64, 8192, 8), (32, 16384, 8),
                    (7, 100, 8)]
#: (M, K, D) association problems of ``tests/test_track_query.py``
ASSOC_SHAPES = [(5, 7, 16), (1, 1, 4), (16, 16, 32)]
#: simulated seconds of the full-fleet metropolis run: only the duration
#: of the preset (60 s) is cut, never its fleet
METRO_S = 12.0
#: metropolis at the smoke size of the reference's tests and runner
METRO_SMOKE = dict(num_cameras=1024, duration_s=12.0)
#: seconds into the script after which the host's full-fleet metropolis
#: run (a comparison, ~1.5 minutes) is skipped to stay inside the limit
HOST_METRO_BUDGET_S = 420.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(msg: str) -> None:
    print(f"== {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int) -> float:
    """Stream time per call of ``fn``: a held stream lets the host enqueue
    all ``reps`` calls before the first runs."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_within_gate(what: str, got: dict, want: dict) -> None:
    """The card's summary against the CPU's where they differ (floats
    summed in another order): every differing key must carry a
    ``GATE_BANDS`` band and lie within it; counts must match exactly."""
    diff = {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k]}
    print(f"differing keys (cuda, cpu): {diff}", flush=True)
    for k, (g, w) in diff.items():
        if k not in GATE_BANDS:
            fail(f"{what} {k} differs between cuda and cpu and has no "
                 f"band: {g} vs {w}")
        kind, band, floor = GATE_BANDS[k]
        tol = band if kind == "abs" else max(band * abs(w), floor)
        if not abs(g - w) <= tol:
            fail(f"{what} {k}: cuda {g} vs cpu {w} outside +-{tol}")


def max_err(got, want) -> float:
    """Largest absolute difference over matching output tensors."""
    return max(float((g.double() - w.double()).abs().max()) if g.numel()
               else 0.0 for g, w in zip(got, want))


def check_triage(torch, T, ops, dev) -> None:
    """Kernel == plain version on the card, integers exactly."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def same(got, want, what):
        for a, b in zip(got, want):
            if not torch.equal(a.cpu(), b.cpu()):
                fail(f"triage {what}: kernel and plain version differ")

    def case(rows, n, capacity, what, pad_rows=0, nan=False):
        conf = torch.rand((rows, n), generator=g)
        if pad_rows:
            conf[-pad_rows:] = -1.0
        if nan:
            conf[0, :3] = float("nan")
        thr = torch.stack([0.5 + 0.5 * torch.rand(rows, generator=g),
                           0.45 * torch.rand(rows, generator=g)], dim=1)
        conf, thr = conf.to(dev), thr.to(dev)
        same(T.triage_fleet(conf, thr, capacity=capacity),
             T.triage_fleet_torch(conf, thr, capacity=capacity), what)

    case(64, 32, 64, "64x32")
    case(64, 200, 4, "capacity overflow")
    case(16, 40, 8, "all-pad rows", pad_rows=5)
    case(8, 33, 8, "NaN lanes", nan=True)
    case(1 << 17, 8, 8, "2^17 rows")
    conf3 = torch.rand((3, 5, 21), generator=g)
    thr3 = torch.stack([0.5 + 0.5 * torch.rand((3, 5), generator=g),
                        0.45 * torch.rand((3, 5), generator=g)], dim=2)
    same(ops.triage_fleet(conf3, thr3, capacity=6, device=dev),
         ops.triage_fleet(conf3, thr3, capacity=6, device="cpu"),
         "3D Q=3 fold")
    one = torch.rand(13, generator=g)
    same(ops.triage_batched(one, alpha=0.7, beta=0.2, capacity=3,
                            device=dev),
         ops.triage_batched(one, alpha=0.7, beta=0.2, capacity=3,
                            device="cpu"), "one row (triage_batched)")


def label_rows(torch, rows: int, n: int, seed: int):
    """Scores/truths from a known logistic, with degenerate rows: too few
    labels, one class only, and all pad."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = 0.02 + 0.96 * torch.rand((rows, n), generator=g)
    logit = torch.log(s / (1 - s))
    p = torch.sigmoid(2.0 * logit + 0.5)
    truths = (torch.rand((rows, n), generator=g) < p).float()
    lengths = torch.randint(n // 4, n + 1, (rows,), generator=g)
    lengths[1] = 4                      # below min_count
    lengths[-1] = 0                     # all pad
    truths[2] = 1.0                     # one class only
    lane = torch.arange(n)[None, :]
    scores = torch.where(lane < lengths[:, None], s, -1.0)
    truths = torch.where(lane < lengths[:, None], truths, 0.0)
    return scores, truths


def check_calibrate(torch, C, dev) -> None:
    """Kernel vs plain version on the card: counts exact, params within
    CAL_ATOL, degenerate rows exactly (1, 0)."""
    for rows in (4, 64):
        scores, truths = (t.to(dev) for t in label_rows(torch, rows, 256,
                                                        rows))
        kp, kc = C.calibrate_fleet(scores, truths, iters=8, min_count=8)
        pp, pc = C.calibrate_fleet_torch(scores, truths, iters=8,
                                         min_count=8)
        if not torch.equal(kc.cpu(), pc.cpu()):
            fail(f"calibrate R={rows}: counts differ")
        err = float((kp - pp).abs().max())
        if not err <= CAL_ATOL:
            fail(f"calibrate R={rows}: params differ by {err} > {CAL_ATOL}")
        ident = torch.tensor([1.0, 0.0], device=dev)
        for r in (1, 2, rows - 1):
            if not torch.equal(kp[r], ident):
                fail(f"calibrate R={rows}: degenerate row {r} fitted to "
                     f"{kp[r].tolist()}, not the identity")


def pixel_frames(torch, g, B: int, H: int, W: int, kind: str = "random"):
    """Three (B, H, W, 3) int32 frames in [0, 255] on the CPU.  ``sparse``:
    a flat scene where only camera 0 has a moving block; ``static``: three
    copies of one random frame."""
    if kind == "random":
        return [torch.randint(0, 256, (B, H, W, 3), generator=g,
                              dtype=torch.int32) for _ in range(3)]
    if kind == "static":
        f = torch.randint(0, 256, (B, H, W, 3), generator=g,
                          dtype=torch.int32)
        return [f, f.clone(), f.clone()]
    base = torch.full((B, H, W, 3), 30, dtype=torch.int32)
    f1 = base.clone()
    f1[0, H // 3:H // 3 + 16, W // 2:W // 2 + 16] = 200
    return [base, f1, base.clone()]


def check_pixel(torch, FD, MO, PC, ops, dev) -> None:
    """Kernels == plain versions on the card, exactly (integers), and the
    fused cascade == the staged framediff -> dilate -> erode launches."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def same(what, got, want):
        for a, b in zip(got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"pixel {what}: kernel and plain version differ")

    def case(fs, threshold, what):
        fs = [f.to(dev) for f in fs]
        kw = dict(threshold=threshold, maxval=255)
        fused = PC.pixel_cascade(*fs, **kw)
        same(f"cascade {what}", fused, PC.pixel_cascade_torch(*fs, **kw))
        fd = FD.framediff(*fs, **kw)
        same(f"framediff {what}", (fd,), (FD.framediff_torch(*fs, **kw),))
        di = MO.dilate3x3(fd)
        same(f"dilate {what}", (di,),
             (MO.morph3x3_torch(fd, op="max", fill=0),))
        er = MO.erode3x3(di, 255)
        same(f"erode {what}", (er,),
             (MO.morph3x3_torch(di, op="min", fill=255),))
        staged = ops.pixel_cascade(*fs, threshold=threshold, fused=False,
                                   device=dev)
        same(f"fused vs staged {what}", fused, staged)
        same(f"fused vs staged mask {what}", (fused[0],), (er,))
        return fused

    for i, (B, H, W) in enumerate(PIXEL_SHAPES):
        for threshold in (0, 40, 200):
            case(pixel_frames(torch, g, B, H, W), threshold,
                 f"{(B, H, W)} threshold {threshold}")
    _, counts = case(pixel_frames(torch, g, 2, 96, 128, "sparse"), 40,
                     "sparse motion")
    if not (int(counts[0]) > 0 and int(counts[1]) == 0):
        fail(f"pixel sparse motion: counts {counts.tolist()}")
    mask, counts = case(pixel_frames(torch, g, 2, 40, 50, "static"), 0,
                        "static scene")
    if bool(mask.any()) or bool(counts.any()):
        fail("pixel static scene: foreground on a motionless scene")
    u8 = [f.to(torch.uint8) for f in pixel_frames(torch, g, 3, 96, 128)]
    same("uint8 frames",
         [t.cpu() for t in ops.pixel_cascade(*u8, device=dev)],
         ops.pixel_cascade(*u8, device="cpu"))
    _, counts = case(pixel_frames(torch, g, *HD), 40, f"1080p {HD}")
    print(f"pixel kernels exact at {len(PIXEL_SHAPES)} shapes x 3 "
          f"thresholds, sparse, static, uint8 and {HD} (foreground "
          f"{counts.tolist()})", flush=True)


class StageClock:
    """Wraps ``module.attr`` to add its synchronised wall time to
    ``seconds`` (``label_components``: the CCL share of framediff_s)."""

    def __init__(self, torch, module, attr: str):
        self.torch, self.module, self.attr = torch, module, attr
        self.inner = getattr(module, attr)
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = self.inner(*args, **kw)
            if out.is_cuda:
                self.torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)


def count_batches(model) -> list:
    """Record the token shape of every call of ``model`` (one classifier
    batch each) in the returned list."""
    shapes = []
    inner = model.forward

    def counted(tokens):
        shapes.append(tuple(tokens.shape))
        return inner(tokens)
    model.forward = counted
    return shapes


def stream_diff(got, want) -> float:
    """Max |conf| difference of two item streams whose other fields must
    be identical."""
    if len(got) != len(want):
        fail(f"pixel_city streams differ in length: {len(got)} vs "
             f"{len(want)}")
    for a, b in zip(got, want):
        for f in ("t_arrival", "camera", "edge_device", "is_query",
                  "nbytes"):
            if getattr(a, f) != getattr(b, f):
                fail(f"pixel_city streams differ in {f}: {a} vs {b}")
    return max((abs(a.conf - b.conf) for a, b in zip(got, want)),
               default=0.0)


def pixel_bound_ms(name: str, shape) -> tuple:
    """Least time for ``name`` over (B, H, W) pixels: bytes over HBM rate
    or integer operations over the scalar rate, whichever is larger."""
    px = shape[0] * shape[1] * shape[2]
    t_b = px * PIXEL_BYTES[name] / HBM_BYTES_S
    t_o = px * PIXEL_OPS[name] / F32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


class Recorder:
    """Wraps a kernel wrapper to keep the first input of every distinct
    first-argument shape the main path gives it (copies of the tensors,
    then the keywords, for timing afterwards); with ``keep_all`` also
    every call's input, in order, in ``calls``."""

    def __init__(self, module, attr: str, keep_all: bool = False):
        self.module, self.attr = module, attr
        self.inner = getattr(module, attr)
        self.inputs = {}
        self.keep_all = keep_all
        self.calls = []

    def __enter__(self):
        def wrapped(*args, **kw):
            key = tuple(args[0].shape)
            if key not in self.inputs or self.keep_all:
                copy = (*(a.clone() for a in args), kw)
                self.inputs.setdefault(key, copy)
                if self.keep_all:
                    self.calls.append(copy)
            return self.inner(*args, **kw)
        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)


def triage_bound_ms(rows: int, n: int) -> tuple:
    nbytes = rows * n * 12 + rows * 12
    ops = rows * n * 4
    return max(nbytes / HBM_BYTES_S, ops / F32_FLOP_S) * 1e3, \
        "bytes" if nbytes / HBM_BYTES_S >= ops / F32_FLOP_S else "operations"


def calibrate_bound_ms(rows: int, n: int, iters: int) -> tuple:
    nbytes = rows * n * 8 + rows * 12
    ops = rows * n * (8 + 20 * iters)   # prologue + one Newton step a lane
    t_b, t_o = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def superstep_slab(torch, g, S: int, R: int, N: int, mask: str = "random"):
    """A superstep input on the CPU: confidences with pad lanes, start
    thresholds, a tick mask (``random``, all ``off`` or all ``on``), and
    drains below, at and above the interval."""
    conf = torch.rand((S, R, N), generator=g)
    lengths = torch.randint(0, N + 1, (S, R), generator=g)
    conf[torch.arange(N)[None, None, :] >= lengths[..., None]] = -1.0
    th0 = torch.stack([0.5 + 0.5 * torch.rand(R, generator=g),
                       0.45 * torch.rand(R, generator=g)], dim=1)
    masks = {"random": lambda: torch.rand((S, R), generator=g) < 0.6,
             "off": lambda: torch.zeros((S, R), dtype=torch.bool),
             "on": lambda: torch.ones((S, R), dtype=torch.bool)}
    interval = 0.1
    drain = 0.3 * torch.rand(R, generator=g)
    drain[: R // 4] = interval
    gains = torch.tensor([0.05, 0.2, 0.3, interval])
    return conf, th0, masks[mask](), drain, gains


def same_superstep(torch, SS, args) -> None:
    """Kernel == plain version on one input, every output bit for bit."""
    *ts, kw = args
    got, want = SS.superstep(*ts, **kw), SS.superstep_torch(*ts, **kw)
    for a, b, what in zip(got, want, ("routes", "slots", "ths")):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"superstep {what} differ from the plain version at "
                 f"{tuple(ts[0].shape)}")


def check_superstep(torch, SS, dev) -> None:
    g = torch.Generator(device="cpu").manual_seed(2)
    cases = [(shape, 8, "random") for shape in SUPERSTEP_SHAPES]
    cases += [((5, 64, 8), 8, "off"), ((5, 64, 8), 8, "on"),
              ((3, 32, 40), 3, "on")]            # the last overflows
    for (S, R, N), capacity, mask in cases:
        ins = [t.to(dev) for t in superstep_slab(torch, g, S, R, N, mask)]
        same_superstep(torch, SS, (*ins, {"capacity": capacity}))
    print(f"superstep bit-exact at {SUPERSTEP_SHAPES}, masks off/on and "
          f"capacity overflow", flush=True)


def assoc_problem(torch, F, g, m: int, k: int, d: int, nq: int = 2):
    emb = F.normalize(torch.randn((m, d), generator=g), dim=1)
    trk = F.normalize(torch.randn((k, d), generator=g), dim=1)
    cq = torch.randint(0, nq, (m,), generator=g, dtype=torch.int32)
    tq = torch.randint(0, nq, (k,), generator=g, dtype=torch.int32)
    thr = -0.5 + 1.4 * torch.rand(m, generator=g)
    return emb, trk, cq, tq, thr


def assoc_diff(torch, got, want) -> float:
    """``assign`` must be equal; returns max |sim difference|."""
    if not torch.equal(got[0].cpu(), want[0].cpu()):
        flips = int((got[0].cpu() != want[0].cpu()).sum())
        fail(f"associate: {flips} assignments differ from the plain "
             f"version")
    return float((got[1].cpu() - want[1].cpu()).abs().max()) \
        if got[1].numel() else 0.0


def check_associate(torch, F, SIM, ops, dev) -> None:
    g = torch.Generator(device="cpu").manual_seed(3)
    problems = [assoc_problem(torch, F, g, *mkd) for mkd in ASSOC_SHAPES]
    problems.append(assoc_problem(torch, F, g, 4, 0, 8))          # K = 0
    emb, trk, cq, tq, thr = assoc_problem(torch, F, g, 6, 5, 8)
    cq[::2] = 7                      # a query that owns no track
    problems.append((emb, trk, cq, tq, torch.full((6,), -0.9)))
    trk = torch.tensor([[0.0, 1, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]])
    emb = torch.tensor([[1.0, 0, 0, 0], [1, 0, 0, 0]])
    tie = (emb, trk, torch.zeros(2, dtype=torch.int32),
           torch.zeros(3, dtype=torch.int32), torch.full((2,), 0.5))
    problems.append(tie)
    err = 0.0
    for problem in problems:
        ins = [t.to(dev) for t in problem]
        err = max(err, assoc_diff(torch, SIM.associate(*ins),
                                  SIM.associate_torch(*ins)))
        err = max(err, assoc_diff(
            torch, ops.associate_tracks(*problem, device=dev),
            ops.associate_tracks(*problem, device="cpu")))
    if not err <= SIM_ATOL:
        fail(f"associate sim differs by {err} > {SIM_ATOL}")
    assign = SIM.associate(*(t.to(dev) for t in tie))[0].tolist()
    if assign != [1, 2]:
        fail(f"associate tie: {assign}, want the lowest index first [1, 2]")
    print(f"associate exact at {ASSOC_SHAPES}, K=0, a masked query and a "
          f"tie; sim within {err:.3g}", flush=True)


class TickAudit:
    """Wraps ``TrackStage.tick`` to check the launch budget tick by tick:
    exactly one associate launch where the tick has crops and a live
    track table, none elsewhere."""

    def __init__(self, TK, SIM):
        self.TK, self.SIM = TK, SIM
        self.inner = TK.TrackStage.tick
        self.ticks = self.expected = self.bad = 0

    def __enter__(self):
        audit = self

        def wrapped(stage, t, batches):
            crops = any(it.emb is not None for b in batches.values()
                        for it in b)
            live = any(tr.last_seen >= t - stage.sc.track_ttl_s
                       for tr in stage.tracks.values())
            before = audit.SIM.LAUNCHES
            out = audit.inner(stage, t, batches)
            want = int(crops and live)
            audit.ticks += 1
            audit.expected += want
            audit.bad += int(audit.SIM.LAUNCHES - before != want)
            return out
        self.TK.TrackStage.tick = wrapped
        return self

    def __exit__(self, *exc):
        self.TK.TrackStage.tick = self.inner


def superstep_bound_ms(S: int, R: int, N: int) -> tuple:
    nbytes = S * R * N * 12 + S * R * 9 + R * 12
    ops = S * R * N * 4 + S * R * 6
    t_b, t_o = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def associate_bound_ms(M: int, K: int, D: int) -> tuple:
    nbytes = (M + K) * D * 4 + M * 8 + K * 4 + M * 8
    ops = 2 * M * K * D
    t_b, t_o = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def time_pixel_kernels(torch, F, FD, MO, PC, dev, recorders: dict,
                       counts: dict) -> list:
    """The ``{"kernels": [...]}`` rows of the three pixel kernels, timed on
    the largest input ``pixel_city`` gave each (``recorders``: the cascade
    in the fused run, framediff and the dilate binding of morph3x3 in the
    staged run) and at ``HD``.  Every recorded input is first re-checked
    against the plain version.  ``counts`` holds each path's launches."""
    g = torch.Generator(device="cpu").manual_seed(1)
    hd = [f.to(dev) for f in pixel_frames(torch, g, *HD)]
    fd_kw = dict(threshold=40, maxval=255)
    dilate_kw = dict(op="max", fill=0)
    specs = {   # name: (source, TPU kernel, kernel, plain, 1080p args)
        "pixel_cascade": ("pixel_cascade.cu", "pixel_cascade.py:123",
                          PC.pixel_cascade, PC.pixel_cascade_torch,
                          (*hd, fd_kw)),
        "framediff": ("framediff.cu", "framediff.py:39", FD.framediff,
                      FD.framediff_torch, (*hd, fd_kw)),
        "morph3x3": ("morphology.cu", "morphology.py:88", MO.morph3x3,
                     MO.morph3x3_torch,
                     (FD.framediff(*hd, **fd_kw), dilate_kw)),
    }

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def check(name, kernel, plain, args) -> float:
        *ts, kw = args
        got, want = as_tuple(kernel(*ts, **kw)), as_tuple(plain(*ts, **kw))
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                fail(f"{name} differs from its plain version at "
                     f"{tuple(ts[0].shape)}")
        return max_err(got, want)

    def measure(name, kernel, plain, args) -> dict:
        *ts, kw = args
        library_ms = None
        if name == "morph3x3":
            if kw != dilate_kw:
                fail(f"morph3x3 timed at {kw}, not the dilate binding")
            # the same dilate of a 0/255 mask: -inf padding == fill 0
            xf = ts[0].float()[:, None]
            if not torch.equal(F.max_pool2d(xf, 3, 1, 1)[:, 0],
                               plain(*ts, **kw).float()):
                fail("max_pool2d is not the dilate on this mask")
            library_ms = device_ms(torch, lambda: F.max_pool2d(xf, 3, 1, 1),
                                   100)
        bound, by = pixel_bound_ms(name, ts[0].shape)
        return {"shape": list(ts[0].shape[:3]),
                "max_abs_err": check(name, kernel, plain, args),
                "ms": device_ms(torch, lambda: kernel(*ts, **kw), 100),
                "plain_ms": device_ms(torch, lambda: plain(*ts, **kw), 10),
                "bound_ms": bound, "bound_by": by, "library_ms": library_ms}

    out = []
    for name, (source, replaces, kernel, plain, hd_args) in specs.items():
        rec = recorders[name]
        for args in rec.inputs.values():
            check(name, kernel, plain, args)
        largest = rec.inputs[max(rec.inputs,
                                 key=lambda s: s[0] * s[1] * s[2])]
        by_path = {path: c["morphology" if name == "morph3x3" else name]
                   for path, c in counts.items()}
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **measure(name, kernel, plain, largest),
            "library": "F.max_pool2d(x.float()[:, None], 3, 1, 1)"
            if name == "morph3x3" else None,
            "at_1080p": measure(name, kernel, plain, hd_args)})
    return out


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F
    from repro_torch.detection import components
    from repro_torch.kernels import calibrate as C
    from repro_torch.kernels import framediff as FD
    from repro_torch.kernels import morphology as MO
    from repro_torch.kernels import ops, runtime
    from repro_torch.kernels import pixel_cascade as PC
    from repro_torch.kernels import similarity as SIM
    from repro_torch.kernels import superstep as SS
    from repro_torch.kernels import triage as T
    from repro_torch.serving.engine import AsyncDriver, VirtualClock
    from repro_torch.system import (PixelFrontend, city_scale, crowd_flow,
                                    drifting_city, metropolis, pixel_city,
                                    run_query, vehicle_pursuit)
    from repro_torch.system import tracks as TK
    from repro_torch.system.scenario import frame_schedule
    counters = (T, C, FD, MO, PC, SS, SIM)

    def zero_counts():
        for mod in counters:
            mod.LAUNCHES = 0

    def read_counts():
        return {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in counters}

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    phase("card")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    built = runtime.build(runtime.KERNELS)
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, info in sorted(built.items()):
        print(f"-- {name}: {info['path']}\n{info['log'].strip()}")
        runtime.library(name)

    phase("kernels vs plain versions")
    check_triage(torch, T, ops, dev)
    check_calibrate(torch, C, dev)
    torch.cuda.synchronize()
    print("triage exact, calibrate within", CAL_ATOL, flush=True)
    check_pixel(torch, FD, MO, PC, ops, dev)
    torch.cuda.synchronize()
    check_superstep(torch, SS, dev)
    check_associate(torch, F, SIM, ops, dev)
    torch.cuda.synchronize()

    phase("main path: city_scale (64 edges, 512 cameras, 60 s)")
    sc = city_scale(duration_s=60.0)
    with Recorder(T, "triage_fleet") as tri_city:
        zero_counts()
        t0 = time.perf_counter()
        rep = run_query(sc, device="cuda")
        torch.cuda.synchronize()
        city_cuda_s = time.perf_counter() - t0
        city_launches = (T.LAUNCHES, C.LAUNCHES)
    s_cuda = rep.summary()
    t0 = time.perf_counter()
    s_cpu = run_query(sc, device="cpu").summary()
    city_cpu_s = time.perf_counter() - t0
    print(f"cuda {city_cuda_s:.2f} s, cpu {city_cpu_s:.2f} s, "
          f"{rep.n_items} items, launches {city_launches}, "
          f"shapes {sorted(tri_city.inputs)}", flush=True)
    if city_launches[0] == 0:
        fail("city_scale launched the triage kernel no time")
    if city_launches[0] != s_cuda["kernel_launches"]:
        fail(f"triage launches {city_launches[0]} != kernel_launches "
             f"{s_cuda['kernel_launches']}")
    if s_cuda != s_cpu:
        diff = {k: (s_cuda[k], s_cpu.get(k)) for k in s_cuda
                if s_cuda[k] != s_cpu.get(k)}
        fail(f"city_scale summary differs between cuda and cpu: {diff}")
    if rep.n_items == 0 or not all(
            v == v for v in s_cuda.values() if isinstance(v, float)):
        fail("city_scale answered nothing or reported NaN")

    phase("feedback path: drifting_city (8 cameras, 60 s)")
    dsc = drifting_city(num_cameras=8, duration_s=60.0)
    with Recorder(T, "triage_fleet") as tri_drift, \
            Recorder(C, "calibrate_fleet") as cal_drift:
        zero_counts()
        t0 = time.perf_counter()
        d_cuda = run_query(dsc, device="cuda").summary()
        torch.cuda.synchronize()
        drift_cuda_s = time.perf_counter() - t0
        drift_launches = (T.LAUNCHES, C.LAUNCHES)
    d_open = run_query(dataclasses.replace(dsc, update_period_s=None),
                       device="cuda").summary()
    d_cpu = run_query(dsc, device="cpu").summary()
    drift_same = d_cuda == d_cpu
    print(f"cuda {drift_cuda_s:.2f} s, launches {drift_launches}, "
          f"model_updates {d_cuda['model_updates']}, F2 closed "
          f"{d_cuda['accuracy_F2']} vs open {d_open['accuracy_F2']}, "
          f"calibrate shapes {sorted(cal_drift.inputs)}, summary "
          f"{'identical to' if drift_same else 'differs from'} cpu",
          flush=True)
    if not drift_same:
        check_within_gate("drifting_city", d_cuda, d_cpu)
    if drift_launches[0] == 0 or drift_launches[0] != d_cuda["kernel_launches"]:
        fail(f"drifting_city triage launches {drift_launches[0]} vs "
             f"kernel_launches {d_cuda['kernel_launches']}")
    if not 0 < d_cuda["model_updates"] == drift_launches[1]:
        fail(f"calibrate launches {drift_launches[1]} vs model_updates "
             f"{d_cuda['model_updates']} (must be equal and > 0)")
    if not d_cuda["accuracy_F2"] > d_open["accuracy_F2"]:
        fail("the closed feedback loop did not beat the open-loop ablation")

    phase("pixel path: pixel_city (12 cameras, 4 edges, 12 s)")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: they would move the classifier's "
             "confidences")
    psc = pixel_city()
    ticks = frame_schedule(psc).shape[0]
    fe = PixelFrontend(seed=0, device="cuda")
    batches = count_batches(fe.model)
    with Recorder(PC, "pixel_cascade") as pc_rec, \
            StageClock(torch, components, "label_components") as ccl:
        zero_counts()
        t0 = time.perf_counter()
        prep = run_query(psc, frontend=fe, device="cuda")
        torch.cuda.synchronize()
        pixel_cuda_s = time.perf_counter() - t0
        pixel_counts = read_counts()
    p_cuda = prep.summary()
    split_cuda = {**fe.timings, "ccl_s": ccl.seconds}
    print(f"cuda {pixel_cuda_s:.2f} s, {prep.n_items} items, {ticks} ticks, "
          f"launches {pixel_counts}, classifier batches {batches}",
          flush=True)
    print(f"card split: render {split_cuda['render_s']:.3f} s, framediff "
          f"{split_cuda['framediff_s']:.3f} s (CCL {ccl.seconds:.3f} s in "
          f"{ccl.calls} calls), classify {split_cuda['classify_s']:.3f} s, "
          f"triage {prep.stage_timings['triage_s']:.3f} s", flush=True)
    if pixel_counts["pixel_cascade"] != ticks or ticks == 0:
        fail(f"pixel_cascade launches {pixel_counts['pixel_cascade']} != "
             f"ticks {ticks}")
    if not 0 < len(batches) == fe.launches:
        fail(f"classifier batches {len(batches)} vs fe.launches "
             f"{fe.launches} (must be equal and > 0)")
    if any(n < 8 or n & (n - 1) for n, _ in batches):
        fail(f"classifier batches not bucket-padded: {batches}")
    if pixel_counts["triage"] != p_cuda["kernel_launches"]:
        fail(f"pixel_city triage launches {pixel_counts['triage']} != "
             f"kernel_launches {p_cuda['kernel_launches']}")
    if pixel_counts["framediff"] or pixel_counts["morphology"]:
        fail("the fused pixel path launched a staged kernel")
    if prep.n_items == 0 or not all(
            v == v for v in p_cuda.values() if isinstance(v, float)):
        fail("pixel_city answered nothing or reported NaN")
    # the same stream again on the card, set-up paid (cuBLAS, allocator):
    # the steady-state split
    fe_warm = PixelFrontend(seed=0, device="cuda")
    with StageClock(torch, components, "label_components") as ccl_warm:
        fe_warm.stream(psc)
        torch.cuda.synchronize()
    split_warm = {**fe_warm.timings, "ccl_s": ccl_warm.seconds}
    print(f"card split, second run: render {split_warm['render_s']:.3f} s, "
          f"framediff {split_warm['framediff_s']:.3f} s (CCL "
          f"{ccl_warm.seconds:.3f} s), classify "
          f"{split_warm['classify_s']:.3f} s", flush=True)
    fe_cpu = PixelFrontend(seed=0, device="cpu")
    with StageClock(torch, components, "label_components") as ccl_cpu:
        t0 = time.perf_counter()
        p_cpu = run_query(psc, frontend=fe_cpu, device="cpu").summary()
        pixel_cpu_s = time.perf_counter() - t0
    split_cpu = {**fe_cpu.timings, "ccl_s": ccl_cpu.seconds}
    dconf = stream_diff(fe.stream(psc), fe_cpu.stream(psc))
    pixel_same = p_cuda == p_cpu
    print(f"cpu {pixel_cpu_s:.2f} s; host split: render "
          f"{split_cpu['render_s']:.3f} s, framediff "
          f"{split_cpu['framediff_s']:.3f} s (CCL {ccl_cpu.seconds:.3f} s), "
          f"classify {split_cpu['classify_s']:.3f} s; stream max |dconf| "
          f"{dconf:.3g}; summary "
          f"{'identical to' if pixel_same else 'differs from'} cpu",
          flush=True)
    if not dconf <= CONF_ATOL:
        fail(f"pixel_city conf differs by {dconf} > {CONF_ATOL} between "
             f"cuda and cpu")
    if not pixel_same:
        check_within_gate("pixel_city", p_cuda, p_cpu)
    fe_staged = PixelFrontend(seed=0, fused=False, device="cuda")
    with Recorder(FD, "framediff") as fd_rec, \
            Recorder(MO, "morph3x3") as mo_rec:
        zero_counts()
        t0 = time.perf_counter()
        staged_items = fe_staged.stream(psc)
        torch.cuda.synchronize()
        staged_s = time.perf_counter() - t0
        staged_counts = read_counts()
    print(f"staged (fused=False) stream in {staged_s:.2f} s, launches "
          f"{staged_counts}", flush=True)
    if staged_items != fe.stream(psc):
        fail("fused=False gave another stream than the fused cascade")
    if (staged_counts["framediff"], staged_counts["morphology"],
            staged_counts["pixel_cascade"]) != (ticks, 2 * ticks, 0):
        fail(f"staged launches {staged_counts} vs {ticks} ticks (want "
             f"framediff = ticks, morphology = 2 x ticks, cascade 0)")

    phase(f"superstep path: metropolis, full fleet, {METRO_S} s")
    msc = metropolis(duration_s=METRO_S)
    with Recorder(SS, "superstep", keep_all=True) as ss_full:
        zero_counts()
        t0 = time.perf_counter()
        mrep = run_query(msc, device="cuda")
        torch.cuda.synchronize()
        metro_cuda_s = time.perf_counter() - t0
        metro_counts = read_counts()
    m_cuda = mrep.summary()
    print(f"cuda {metro_cuda_s:.2f} s for {METRO_S} s of {msc.num_cameras} "
          f"cameras, {msc.num_edges} edges, {len(msc.queries)} queries: "
          f"{mrep.n_items} items, triaged_ticks {mrep.triaged_ticks}, "
          f"supersteps {mrep.supersteps}, superstep launches "
          f"{metro_counts['superstep']}, triage launches "
          f"{metro_counts['triage']}, stage_timings {mrep.stage_timings}, "
          f"slabs {[list(a[0].shape) for a in ss_full.calls]}", flush=True)
    if (msc.num_cameras, msc.num_edges, len(msc.queries)) != (10240, 1024, 24):
        fail("metropolis is not at the preset's full fleet")
    if not 0 < metro_counts["superstep"] == mrep.supersteps:
        fail(f"superstep launches {metro_counts['superstep']} != supersteps "
             f"{mrep.supersteps} (must be equal and > 0)")
    if not mrep.triaged_ticks / mrep.supersteps >= 10.0:
        fail(f"metropolis fused only {mrep.triaged_ticks} / "
             f"{mrep.supersteps} triaged ticks per superstep")
    if mrep.n_items == 0 or not all(
            v == v for v in m_cuda.values() if isinstance(v, float)):
        fail("metropolis answered nothing or reported NaN")
    metro_cpu_s = None
    if time.perf_counter() - t_all < HOST_METRO_BUDGET_S:
        t0 = time.perf_counter()
        m_cpu = run_query(msc, device="cpu").summary()
        metro_cpu_s = time.perf_counter() - t0
        print(f"cpu {metro_cpu_s:.2f} s, summary "
              f"{'identical to' if m_cpu == m_cuda else 'differs from'} "
              f"cuda", flush=True)
        if m_cpu != m_cuda:
            diff = {k: (m_cuda[k], m_cpu.get(k)) for k in m_cuda
                    if m_cuda[k] != m_cpu.get(k)}
            fail(f"full-fleet metropolis differs between cuda and cpu: {diff}")
    else:
        print(f"cpu run of the full fleet skipped: "
              f"{time.perf_counter() - t_all:.0f} s into the script",
              flush=True)

    def report_view(r):
        return (r.summary(), r.per_query_summary(), r.accuracy_timeline(),
                r.thresholds, r.queries)

    ssc = metropolis(**METRO_SMOKE)
    with Recorder(SS, "superstep", keep_all=True) as ss_smoke:
        zero_counts()
        t0 = time.perf_counter()
        rs_cuda = run_query(ssc, device="cuda")
        torch.cuda.synchronize()
        smoke_cuda_s = time.perf_counter() - t0
        smoke_counts = read_counts()
    t0 = time.perf_counter()
    rs_cpu = run_query(ssc, device="cpu")
    smoke_cpu_s = time.perf_counter() - t0
    if report_view(rs_cuda) != report_view(rs_cpu):
        fail("metropolis smoke report differs between cuda and cpu")
    zero_counts()
    r1 = run_query(dataclasses.replace(ssc, superstep=1), device="cuda")
    k1_counts = read_counts()
    launch_keys = ("kernel_launches", "launches_per_tick", "supersteps")
    v128, v1 = report_view(rs_cuda), report_view(r1)
    if ({k: v for k, v in v1[0].items() if k not in launch_keys}
            != {k: v for k, v in v128[0].items() if k not in launch_keys}
            or v1[1:] != v128[1:]):
        fail("metropolis superstep=1 is not bit-identical to superstep=128")
    if not k1_counts["superstep"] == r1.supersteps == r1.triaged_ticks:
        fail(f"superstep=1 launched {k1_counts['superstep']} times for "
             f"{r1.triaged_ticks} triaged ticks")
    print(f"smoke size: cuda {smoke_cuda_s:.2f} s, cpu {smoke_cpu_s:.2f} s, "
          f"{rs_cuda.n_items} items, supersteps {rs_cuda.supersteps} "
          f"(launches {smoke_counts['superstep']}) for "
          f"{rs_cuda.triaged_ticks} triaged ticks; report identical to cpu; "
          f"superstep=1 ({k1_counts['superstep']} launches) bit-identical "
          f"to superstep=128", flush=True)
    if smoke_counts["superstep"] != rs_cuda.supersteps:
        fail("smoke superstep launches != supersteps")

    phase("track path: vehicle_pursuit (12 cameras, 6 edges, 60 s), "
          "crowd_flow (8 cameras, 4 edges, 45 s)")
    track = {}
    assoc_recs = {}
    for name, make in (("vehicle_pursuit", vehicle_pursuit),
                       ("crowd_flow", crowd_flow)):
        tsc = make()
        with Recorder(SIM, "associate", keep_all=True) as rec, \
                TickAudit(TK, SIM) as audit:
            zero_counts()
            t0 = time.perf_counter()
            tr = run_query(tsc, device="cuda")
            torch.cuda.synchronize()
            cuda_s = time.perf_counter() - t0
            counts = read_counts()
        assoc_recs[name] = rec
        t_cuda = tr.summary()
        t0 = time.perf_counter()
        t_cpu = run_query(tsc, device="cpu").summary()
        cpu_s = time.perf_counter() - t0
        track[name] = {"cuda_s": cuda_s, "cpu_s": cpu_s, "items": tr.n_items,
                       "ticks": tr.ticks, "track_items": tr.track_items,
                       "track_launches": tr.track_launches,
                       "associate_launches": counts["similarity"],
                       "triage_launches": counts["triage"],
                       "id_switches": tr.id_switches,
                       "prewarm_hits": tr.prewarm_hits,
                       "associate_s": tr.stage_timings["associate_s"],
                       "identical_to_cpu": t_cuda == t_cpu}
        print(f"{name}: {json.dumps(track[name])}; crop shapes "
              f"{sorted(rec.inputs)}", flush=True)
        if t_cuda != t_cpu:
            flips, first = 0, None
            for emb, trk, cq, tq, thr, _ in rec.calls:
                got = SIM.associate(emb, trk, cq, tq, thr)[0].cpu()
                want = SIM.associate_torch(
                    *(t.cpu() for t in (emb, trk, cq, tq, thr)))[0]
                bad = (got != want).nonzero().flatten().tolist()
                flips += len(bad)
                if bad and first is None:
                    first = (tuple(emb.shape), bad[0], int(got[bad[0]]),
                             int(want[bad[0]]))
            fail(f"{name} summary differs between cuda and cpu: "
                 f"{flips} flipped assignments on the recorded inputs, first "
                 f"(shape, crop, cuda, cpu) {first}")
        if not 0 < counts["similarity"] == tr.track_launches <= tr.ticks:
            fail(f"{name}: associate launches {counts['similarity']} vs "
                 f"track_launches {tr.track_launches} vs ticks {tr.ticks}")
        if audit.bad or audit.expected != counts["similarity"]:
            fail(f"{name}: {audit.bad} of {audit.ticks} track ticks broke "
                 f"the one-launch-per-tick-with-crops-and-tracks budget")
    psc_t = vehicle_pursuit()
    off = run_query(dataclasses.replace(psc_t, predictive_handoff=False),
                    device="cuda")
    if not track["vehicle_pursuit"]["id_switches"] < off.id_switches:
        fail(f"vehicle_pursuit: hand-off {track['vehicle_pursuit']['id_switches']}"
             f" id switches, not fewer than the ablation's {off.id_switches}")
    sim_r = run_query(psc_t, device="cuda")
    async_r = run_query(psc_t, driver=AsyncDriver(VirtualClock()),
                        device="cuda")
    if async_r.summary() != sim_r.summary() or not (
            async_r.latencies.shape == sim_r.latencies.shape
            and (async_r.latencies == sim_r.latencies).all()):
        fail("vehicle_pursuit: AsyncDriver(VirtualClock()) differs from "
             "SimDriver on the card")
    print(f"vehicle_pursuit: {track['vehicle_pursuit']['id_switches']} id "
          f"switches with hand-off vs {off.id_switches} without; "
          f"AsyncDriver identical to SimDriver", flush=True)

    phase("timing on the main paths' inputs")
    # the most frequent main-path shape family: time the largest recorded
    # input of each kernel (every recorded input is also re-checked)
    tri_inputs = {**tri_drift.inputs, **tri_city.inputs}
    for conf, thr, kw in tri_inputs.values():
        want = T.triage_fleet_torch(conf, thr, **kw)
        if max_err(T.triage_fleet(conf, thr, **kw), want) != 0.0:
            fail(f"triage differs on a main-path input {tuple(conf.shape)}")
    conf, thr, kw = tri_city.inputs[max(tri_city.inputs,
                                        key=lambda s: s[0] * s[1])]
    t_ms = device_ms(torch, lambda: T.triage_fleet(conf, thr, **kw), 200)
    t_plain = device_ms(torch, lambda: T.triage_fleet_torch(conf, thr, **kw),
                        50)
    t_err = max_err(T.triage_fleet(conf, thr, **kw),
                    T.triage_fleet_torch(conf, thr, **kw))
    t_bound, t_by = triage_bound_ms(*conf.shape)
    cal_err = 0.0
    for scores, truths, ckw in cal_drift.inputs.values():
        kp, kc = C.calibrate_fleet(scores, truths, **ckw)
        pp, pc = C.calibrate_fleet_torch(scores, truths, **ckw)
        if not torch.equal(kc, pc):
            fail("calibrate counts differ on a main-path input")
        cal_err = max(cal_err, float((kp - pp).abs().max()))
    if not cal_err <= CAL_ATOL:
        fail(f"calibrate params differ by {cal_err} on main-path inputs")
    scores, truths, ckw = cal_drift.inputs[max(cal_drift.inputs,
                                               key=lambda s: s[0] * s[1])]
    c_ms = device_ms(torch, lambda: C.calibrate_fleet(scores, truths, **ckw),
                     200)
    c_plain = device_ms(
        torch, lambda: C.calibrate_fleet_torch(scores, truths, **ckw), 20)
    c_bound, c_by = calibrate_bound_ms(*scores.shape, ckw["iters"])
    # the one-row launch (ops.triage / triage_batched, the port of
    # triage_dynamic_pallas): not on the main paths, timed at its bucket
    one = torch.rand((1, 16), device=dev)
    one_thr = torch.tensor([[0.7, 0.2]], device=dev)
    one_ms = device_ms(torch, lambda: T.triage_fleet(one, one_thr,
                                                     capacity=8), 200)
    one_plain = device_ms(
        torch, lambda: T.triage_fleet_torch(one, one_thr, capacity=8), 50)
    pixel_rows = time_pixel_kernels(
        torch, F, FD, MO, PC, dev,
        {"pixel_cascade": pc_rec, "framediff": fd_rec, "morph3x3": mo_rec},
        {"pixel_city": pixel_counts, "pixel_city_staged": staged_counts})
    # the scan superstep: every recorded metropolis slab re-checked bit for
    # bit, the largest (the cap slab where the run reaches it) timed
    ss_calls = ss_full.calls + ss_smoke.calls
    for args in ss_calls:
        same_superstep(torch, SS, args)
    *ss_in, ss_kw = max(ss_full.calls, key=lambda a: a[0].numel())
    ss_ms = device_ms(torch, lambda: SS.superstep(*ss_in, **ss_kw), 100)
    ss_plain = device_ms(torch, lambda: SS.superstep_torch(*ss_in, **ss_kw),
                         5)
    ss_bound, ss_by = superstep_bound_ms(*ss_in[0].shape)
    # the association: every recorded track input re-checked, the largest
    # timed; the library yardstick is the score step alone
    assoc_calls = [c for rec in assoc_recs.values() for c in rec.calls]
    a_err = 0.0
    for *ins, _ in assoc_calls:
        a_err = max(a_err, assoc_diff(torch, SIM.associate(*ins),
                                      SIM.associate_torch(*ins)))
    if not a_err <= SIM_ATOL:
        fail(f"associate sim differs by {a_err} on main-path inputs")
    *a_in, _ = max(assoc_calls, key=lambda a: a[0].shape[0] * a[1].shape[0])
    a_ms = device_ms(torch, lambda: SIM.associate(*a_in), 200)
    a_plain = device_ms(torch, lambda: SIM.associate_torch(*a_in), 10)
    a_lib = device_ms(torch, lambda: torch.matmul(a_in[0], a_in[1].T), 200)
    (am, ad), ak = a_in[0].shape, a_in[1].shape[0]
    a_bound, a_by = associate_bound_ms(am, ak, ad)
    ss_paths = {"metropolis": metro_counts["superstep"],
                "metropolis_smoke": smoke_counts["superstep"],
                "metropolis_smoke_superstep1": k1_counts["superstep"]}
    a_paths = {n: t["associate_launches"] for n, t in track.items()}
    kernels = [
        {"name": "triage_fleet", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/triage.cu",
         "replaces": "src/repro/kernels/triage.py:111",
         "launches": city_launches[0] + drift_launches[0]
         + pixel_counts["triage"],
         "launches_by_path": {"city_scale": city_launches[0],
                              "drifting_city": drift_launches[0],
                              "pixel_city": pixel_counts["triage"]},
         "shape": list(conf.shape), "max_abs_err": t_err,
         "ms": t_ms, "plain_ms": t_plain, "bound_ms": t_bound,
         "bound_by": t_by, "library_ms": None},
        {"name": "calibrate_fleet", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/calibrate.cu",
         "replaces": "src/repro/kernels/calibrate.py:102",
         "launches": city_launches[1] + drift_launches[1],
         "launches_by_path": {"city_scale": city_launches[1],
                              "drifting_city": drift_launches[1],
                              "pixel_city": pixel_counts["calibrate"]},
         "shape": list(scores.shape), "max_abs_err": cal_err,
         "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound,
         "bound_by": c_by, "library_ms": None},
        *pixel_rows,
        {"name": "superstep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/superstep.cu",
         "replaces": "src/repro/system/superstep.py:89",
         "launches": sum(ss_paths.values()), "launches_by_path": ss_paths,
         "shape": list(ss_in[0].shape), "checked_inputs": len(ss_calls),
         "max_abs_err": 0.0, "ms": ss_ms, "plain_ms": ss_plain,
         "bound_ms": ss_bound, "bound_by": ss_by, "library_ms": None},
        {"name": "associate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/associate.cu",
         "replaces": "src/repro/kernels/similarity.py:96",
         "launches": sum(a_paths.values()), "launches_by_path": a_paths,
         "shape": [am, ak, ad], "checked_inputs": len(assoc_calls),
         "max_abs_err": a_err, "ms": a_ms, "plain_ms": a_plain,
         "bound_ms": a_bound, "bound_by": a_by, "library_ms": a_lib,
         "library": "torch.matmul(emb, trk.T): the score step only"},
    ]
    print(json.dumps({"paths": {
        "city_scale": {"cuda_s": city_cuda_s, "cpu_s": city_cpu_s,
                       "items": rep.n_items,
                       "kernel_launches": s_cuda["kernel_launches"]},
        "drifting_city": {"cuda_s": drift_cuda_s,
                          "model_updates": d_cuda["model_updates"],
                          "f2_closed": d_cuda["accuracy_F2"],
                          "f2_open": d_open["accuracy_F2"],
                          "identical_to_cpu": drift_same},
        "pixel_city": {"cuda_s": pixel_cuda_s, "cpu_s": pixel_cpu_s,
                       "staged_cuda_stream_s": staged_s,
                       "items": prep.n_items, "ticks": ticks,
                       "classifier_batches": len(batches),
                       "split_cuda_s": split_cuda,
                       "split_cuda_second_s": split_warm,
                       "split_cpu_s": split_cpu,
                       "max_abs_dconf": dconf,
                       "identical_to_cpu": pixel_same},
        "metropolis": {"cuda_s": metro_cuda_s, "cpu_s": metro_cpu_s,
                       "duration_s": METRO_S, "cameras": msc.num_cameras,
                       "edges": msc.num_edges, "queries": len(msc.queries),
                       "items": mrep.n_items,
                       "triaged_ticks": mrep.triaged_ticks,
                       "supersteps": mrep.supersteps,
                       "superstep_launches": metro_counts["superstep"],
                       "triage_s": mrep.stage_timings["triage_s"],
                       "slabs": [list(a[0].shape) for a in ss_full.calls]},
        "metropolis_smoke": {"cuda_s": smoke_cuda_s, "cpu_s": smoke_cpu_s,
                             "items": rs_cuda.n_items,
                             "triaged_ticks": rs_cuda.triaged_ticks,
                             "supersteps": rs_cuda.supersteps,
                             "superstep1_launches": k1_counts["superstep"],
                             "identical_to_cpu": True,
                             "superstep1_bit_identical": True},
        **track},
        "triage_one_row": {"shape": [1, 16], "ms": one_ms,
                           "plain_ms": one_plain,
                           "bound_ms": triage_bound_ms(1, 16)[0]},
        "total_s": time.perf_counter() - t_all}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
