"""One run of one cell: find its files by name, set up, measure, check,
and read every metric the cell reports.

Everything a cell is made of is found by the names in ``BENCHMARK.json``:
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names the module under
``drivers/`` that runs it and reads its check), the limits of its
correctness check (``checks/<workload>.json``) and a reader for each
metric it reports (``metrics/<metric>.py``, a ``read(run)`` that returns
the value, or None where the run holds nothing to read).  A model
family's FLOP count and plain reference are found by the configuration's
``family`` (``flops/<family>.py``, ``reference/<family>.py``).  A later
cell, mix, configuration, family, driver or metric is new files and
entries, never an edit.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import types
from pathlib import Path
from typing import Dict, List, Optional

import torch

BENCH = Path(__file__).resolve().parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str, where: Path = BENCH / "metrics"):
    """The module of ``metrics/<name>.py``."""
    path = where / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class Cell:
    """One workload: its name, configuration file, traffic mix and the
    limits of its correctness check (``checks/<name>.json``)."""
    name: str
    config: Dict
    mix: Dict
    checks: Dict


@dataclasses.dataclass
class Outcome:
    """What a driver's ``run`` hands back: ``run``, the namespace the
    metric readers read (``setup_s`` and ``window_s`` in every driver's,
    the rest the driver's own), the numbers its check read by name, and
    the run's counts, peak memory and traced slice (``busy_s``,
    ``window_s``, ``breakdown``)."""
    run: types.SimpleNamespace
    readings: Dict[str, float]
    attempted: int
    failed: int
    peak_bytes: int
    trace: Optional[Dict] = None
    extra: Dict = dataclasses.field(default_factory=dict)


def cell(bench: Dict, workload: str, root: Path = BENCH):
    """The Cell of ``workload`` and its BENCHMARK.json entry."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(name=workload,
                config=load_json(root.parent / conf["file"]),
                mix=load_json(root / "traffic" / f"{entry['traffic']}.json"),
                checks=load_json(root / "checks" / f"{workload}.json")
                ), entry


def driver(mix: Dict):
    """The module ``drivers/<mix["driver"]>.py``: its ``run(cell, seed,
    seconds, trace, device, t_start)`` returns an Outcome."""
    return importlib.import_module(f"portbench.drivers.{mix['driver']}")


def judge(readings: Dict, limits: Dict) -> Dict[str, list]:
    """Each compared number beside its limit."""
    return {k: [readings[k], limits[k]] for k in limits}


def measure(bench: Dict, cell_: Cell, seed: int, seconds: float,
            trace: bool, device, t_start: float, chips: int = 1) -> Dict:
    """One run: the result object the command prints as its last line."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    o = driver(cell_.mix).run(cell_, seed, seconds, trace, dev, t_start)
    metrics = {}
    for spec in metrics_of(bench, cell_.name, trace):
        value = reader(spec["name"]).read(o.run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    checks = judge(o.readings, cell_.checks["limits"])
    correct = all(isinstance(v, (int, float)) and not math.isnan(v)
                  and v <= lim for v, lim in checks.values())
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": chips, "memory_peak_bytes": int(o.peak_bytes)}
    out = {"correct": bool(correct), "attempted": o.attempted,
           "failed": o.failed, "metrics": metrics, "device": device_info,
           **o.extra}
    if trace and o.trace is not None:
        device_info["busy_s"] = o.trace["busy_s"]
        device_info["window_s"] = o.trace["window_s"]
        if o.trace.get("breakdown"):
            out["breakdown"] = o.trace["breakdown"]
    out["readings"] = {k: v for k, v in o.readings.items() if k not in checks}
    out["checks"] = checks
    return out


def window_only(cell_: Cell, seed: int, dev: torch.device, bursts: int):
    """Set-up and ``bursts`` bursts with nothing read: the program's
    outputs for a study of the check (``study.py``); returns the driver,
    its set-up and its window."""
    drv = driver(cell_.mix)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st, w = drv.window_only(cell_, seed, dev, bursts)
    return drv, st, w


def limits_line(checks: Dict[str, list]) -> List[str]:
    """The compared numbers, one a line: name, value, limit."""
    return [f"check {k} {v!r} limit {lim!r}" for k, (v, lim) in
            checks.items()]


def forbidden_modules(names=("jax", "jaxlib", "flax", "repro",
                             "benchmarks")) -> List[str]:
    """Loaded modules whose top-level name is one of ``names``."""
    import sys
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(names))


def card_count() -> Optional[int]:
    return torch.cuda.device_count() if torch.cuda.is_available() else None
