#!/usr/bin/env python3
"""What a one-card device mesh adds to a full-width train step, and how
much of it is the optimizer's update.

  PYTHONPATH=src python3 tools/mesh_step_time.py [--arch A ...] \\
      [--steps N] [--beside-dryruns] [--trace] [--label TEXT]

Runs on one card, through ``launch/train.py``'s own functions (seed-0
weights drawn on the card, the loader's seed-0 stream, the launcher's
AdamW schedule, every layer rematerialized), ``--steps`` train steps of
8 x 512 tokens of each ``--arch``: first without a mesh, then with
DTensor parameters and AdamW state on a (1, 1) mesh over a one-rank
NCCL group with its ``ActCtx``.  A MoE runs under
``torch.use_deterministic_algorithms`` (its combine is a scatter-add),
as ``chip_smoke.py``'s phase 15 runs it.  For each it reports the
step's wall ms and ``adamw.apply``'s wall ms (timed between two
synchronizations of the card; the step's own end synchronizes it too),
medians of steps 2 to N, and the largest relative gap of (loss,
grad_norm) between the two runs.  On the mesh it counts the leaves of
the parameters and AdamW moments whose placements the steps moved off
the train rules; ``--trace`` profiles one more step of each run and
lists its operators by self host and by self device time.

``--beside-dryruns`` starts the production-shape dry-runs that
``chip_smoke.py`` runs beside its phase 15 (``DRYRUN_CALLS`` there), a
process each on one CPU thread, before the steps, and kills them after:
the host's cores shared as in that script.

The tool reads the port from ``PYTHONPATH``, so one copy of it times
another tree (``PYTHONPATH=<tree>/src``).  Prints the card's name and
power limit, then one JSON line.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: ``chip_smoke.py``'s phase-13 batch, learning rate and schedule length
BATCH, SEQ, LR, SCHEDULE = 8, 512, 3e-4, 30
def start_dryruns(out: str) -> list:
    """``chip_smoke.py``'s ``DRYRUN_CALLS``, a process each on one CPU
    thread, their records under ``out``."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import DRYRUN_CALLS
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", s, "--mesh", m, "--out", out, *extra],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env)
        for a, s, m, extra in DRYRUN_CALLS]


def placements_moved(tree, rules) -> int:
    """How many DTensor leaves of ``tree`` lie otherwise than ``rules``
    (``NamedSharding``s) place them."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import meta as M
    return sum(SH.is_dtensor(t) and tuple(t.placements) != tuple(
        r.placements) for (_, t), (_, r) in zip(M.leaves(tree),
                                                  M.leaves(rules)))


def host_ops(torch, fn, top: int = 12) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (host and, where the
    profiler sees it, device activity): the call's host ms and the
    ``top`` operators by self host ms and by self device ms, [name,
    calls, self host ms, self device ms] (an operator and the kernels it
    launched each show the kernels' device time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    def row(e):
        return [e.key, e.count, e.self_cpu_time_total / 1e3, dev(e)]
    return {"host_ms": host_ms,
            "top_host": [row(e) for e in sorted(
                events, key=lambda e: -e.self_cpu_time_total)[:top]],
            "top_device": [row(e) for e in sorted(
                events, key=lambda e: -dev(e))[:top]]}


def time_steps(torch, cfg, dev, mesh, steps: int, trace: bool = False
               ) -> dict:
    """``steps`` steps of ``cfg`` (on ``mesh``, or plain where None):
    (loss, grad_norm) a step, the step's and ``adamw.apply``'s wall ms;
    on a mesh, the parameters' and moments' leaves whose placements the
    steps moved off the train rules; with ``trace``, one more step's
    host operators (``host_ops``)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import train as LT
    from repro_torch.optim import adamw
    apply, apply_ms = adamw.apply, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply(*a, **k)
        torch.cuda.synchronize()
        apply_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    ctx = SH.ActCtx(cfg, mesh) if mesh is not None else None
    state = LT.init_state(cfg, dev, mesh)
    step = LT.make_step(cfg, lr=LR, steps=SCHEDULE, ctx=ctx)
    data = LT.batches(cfg, BATCH, SEQ, dev, mesh)
    metrics, ms = [], []
    adamw.apply = timed
    try:
        for _ in range(steps):
            batch = next(data)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, mt = step(state, batch)
            metrics.append((float(mt["loss"]), float(mt["grad_norm"])))
            ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        adamw.apply = apply
    out = {"metrics": metrics, "step_ms": statistics.median(ms[1:]),
           "apply_ms": statistics.median(apply_ms[1:])}
    if mesh is not None:
        rules = SH.param_shardings(cfg, mesh, "train")
        out["moved_leaves"] = sum(placements_moved(t, rules) for t in (
            state.params, state.opt.m, state.opt.v))
    if trace:
        batch = next(data)

        def one():
            nonlocal state
            state, mt = step(state, batch)
            float(mt["loss"])
        out["trace"] = host_ops(torch, one)
    del state, step, data
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+",
                    default=["qwen1.5-0.5b", "granite-moe-1b-a400m"])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--beside-dryruns", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="profile one more step of each run (host ops)")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("mesh_step_time: torch finds no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import multihost
    from repro_torch.launch import train as LT
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = {"label": args.label, "torch": torch.__version__,
           "beside_dryruns": args.beside_dryruns, "archs": {}}
    procs, tmp = [], os.path.join("dryrun_out", "mesh_step_time")
    dev = multihost.initialize(f"localhost:{LT.free_port()}", 1, 0,
                               device="cuda")
    try:
        if args.beside_dryruns:
            procs = start_dryruns(tmp)
        mesh = MESH.make_host_mesh("cuda")
        for arch in args.arch:
            cfg = get_config(arch)
            was = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(cfg.is_moe or was,
                                               warn_only=True)
            plain = time_steps(torch, cfg, dev, None, args.steps,
                               args.trace)
            on_mesh = time_steps(torch, cfg, dev, mesh, args.steps,
                                 args.trace)
            torch.use_deterministic_algorithms(was)
            gap = max(abs(a - b) / abs(b) for x, y in zip(
                on_mesh["metrics"], plain["metrics"]) for a, b in zip(x, y))
            out["archs"][arch] = {
                "plain_step_ms": plain["step_ms"],
                "mesh_step_ms": on_mesh["step_ms"],
                "plain_apply_ms": plain["apply_ms"],
                "mesh_apply_ms": on_mesh["apply_ms"],
                "mesh_minus_plain_ms": on_mesh["step_ms"] - plain["step_ms"],
                "rel_gap": gap, "losses": [m[0] for m in on_mesh["metrics"]],
                "moved_leaves": on_mesh["moved_leaves"],
                "plain_trace": plain.get("trace"),
                "mesh_trace": on_mesh.get("trace")}
        out["dryruns_running_at_end"] = sum(p.poll() is None for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
