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
   ``CAL_ATOL`` with exact counts;
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
6. time each kernel and its plain version on the inputs the main paths
   gave it, and print ``{"kernels": [...]}`` (per kernel: launches in
   phases 4-5, max error against the plain version, kernel/plain ms with
   the stream pre-loaded, and the bound from the bytes and operations of
   the timed inputs), then, last, ``{"ok": true, "device": {...}}``.

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
F32_FLOP_S = 67e12
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
#: a pending kernel that holds the stream while the host enqueues a timed
#: loop, so the events time the device, not the Python launch path
HOLD_CYCLES = 500_000_000


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


def check_within_gate(got: dict, want: dict) -> None:
    """The card's summary against the CPU's where they differ (float Platt
    params summed in another order): every differing key must carry a
    ``GATE_BANDS`` band and lie within it; counts must match exactly."""
    diff = {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k]}
    print(f"differing keys (cuda, cpu): {diff}", flush=True)
    for k, (g, w) in diff.items():
        if k not in GATE_BANDS:
            fail(f"drifting_city {k} differs between cuda and cpu and has "
                 f"no band: {g} vs {w}")
        kind, band, floor = GATE_BANDS[k]
        tol = band if kind == "abs" else max(band * abs(w), floor)
        if not abs(g - w) <= tol:
            fail(f"drifting_city {k}: cuda {g} vs cpu {w} outside +-{tol}")


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


class Recorder:
    """Wraps a kernel wrapper to keep the first input of every distinct
    shape the main path gives it (a copy, for timing afterwards)."""

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr
        self.inner = getattr(module, attr)
        self.inputs = {}

    def __enter__(self):
        def wrapped(a, b, **kw):
            key = tuple(a.shape)
            if key not in self.inputs:
                self.inputs[key] = (a.clone(), b.clone(), kw)
            return self.inner(a, b, **kw)
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


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import calibrate as C
    from repro_torch.kernels import ops, runtime
    from repro_torch.kernels import triage as T
    from repro_torch.system import city_scale, drifting_city, run_query

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

    phase("main path: city_scale (64 edges, 512 cameras, 60 s)")
    sc = city_scale(duration_s=60.0)
    with Recorder(T, "triage_fleet") as tri_city:
        T.LAUNCHES = C.LAUNCHES = 0
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
        T.LAUNCHES = C.LAUNCHES = 0
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
        check_within_gate(d_cuda, d_cpu)
    if drift_launches[0] == 0 or drift_launches[0] != d_cuda["kernel_launches"]:
        fail(f"drifting_city triage launches {drift_launches[0]} vs "
             f"kernel_launches {d_cuda['kernel_launches']}")
    if not 0 < d_cuda["model_updates"] == drift_launches[1]:
        fail(f"calibrate launches {drift_launches[1]} vs model_updates "
             f"{d_cuda['model_updates']} (must be equal and > 0)")
    if not d_cuda["accuracy_F2"] > d_open["accuracy_F2"]:
        fail("the closed feedback loop did not beat the open-loop ablation")

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
    kernels = [
        {"name": "triage_fleet", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/triage.cu",
         "replaces": "src/repro/kernels/triage.py:111",
         "launches": city_launches[0] + drift_launches[0],
         "launches_by_path": {"city_scale": city_launches[0],
                              "drifting_city": drift_launches[0]},
         "shape": list(conf.shape), "max_abs_err": t_err,
         "ms": t_ms, "plain_ms": t_plain, "bound_ms": t_bound,
         "bound_by": t_by, "library_ms": None},
        {"name": "calibrate_fleet", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/calibrate.cu",
         "replaces": "src/repro/kernels/calibrate.py:102",
         "launches": city_launches[1] + drift_launches[1],
         "launches_by_path": {"city_scale": city_launches[1],
                              "drifting_city": drift_launches[1]},
         "shape": list(scores.shape), "max_abs_err": cal_err,
         "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound,
         "bound_by": c_by, "library_ms": None},
    ]
    print(json.dumps({"paths": {
        "city_scale": {"cuda_s": city_cuda_s, "cpu_s": city_cpu_s,
                       "items": rep.n_items,
                       "kernel_launches": s_cuda["kernel_launches"]},
        "drifting_city": {"cuda_s": drift_cuda_s,
                          "model_updates": d_cuda["model_updates"],
                          "f2_closed": d_cuda["accuracy_F2"],
                          "f2_open": d_open["accuracy_F2"],
                          "identical_to_cpu": drift_same}},
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
