"""Run the port's query pipeline over its scenarios and write JSON reports.

The port's counterpart of the reference's ``examples/run_scenarios.py``:
the same report schema, the same ``SMOKE_OVERRIDES`` and the same
ablation rows, limited to the presets this slice of the port runs end to
end (``repro_torch.system.PORTED_SCENARIOS``).  Each scenario runs under
all four query schemes; scenarios with the feedback loop on add the
``surveiledge_no_update`` row (``update_period_s=None``), and scenarios
with the bandwidth endgame on add ``surveiledge_fp_wire`` (full-width fp
downlink, blocking escalation).

``--json-out DIR`` writes one ``<scenario>-confidence.json`` per
scenario, which ``benchmarks/report_gate.py`` diffs against the committed
``reports/`` baselines (give it a baseline directory holding only the
ported scenarios' files: a missing scenario is a breach).  The run fails
on NaN metrics, a pipeline that answered nothing, or an internally
inconsistent row.

  PYTHONPATH=src python -m repro_torch.run_scenarios --scenario all \\
      --cameras 4 --duration 30 --json-out .cache/port-reports --device cpu
  PYTHONPATH=src python -m repro_torch.run_scenarios --scenario drifting_city
  PYTHONPATH=src python -m repro_torch.run_scenarios --scenario pixel_city \\
      --duration 10 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

from repro_torch.system import (
    PORTED_SCENARIOS,
    SCENARIOS,
    SCHEMES,
    PixelFrontend,
    run_query,
    synthetic_confidence_stream,
)

# ``--scenario all``: every ported preset at its smoke-sized operating
# point (keys override the CLI defaults) — the settings the committed
# ``reports/`` baselines are built from, so the report gate compares like
# with like.
SMOKE_OVERRIDES = {
    "city_scale": dict(duration=20.0),
    "drifting_city": dict(cameras=8, duration=60.0),
    "multi_query_city": dict(cameras=8, duration=60.0),
    "query_churn": dict(cameras=8, duration=60.0),
    "pixel_city": dict(duration=10.0),
    "rush_hour": dict(cameras=4, duration=40.0),
}
#: presets that exist to exercise the pixel path run on it; the rest on
#: the model-free confidence stream
PIXEL_SCENARIOS = ("pixel_city",)


def check_consistency(name: str, scheme: str, summary: dict) -> None:
    """Raise ``ValueError`` on internally inconsistent report rows: updates
    that shipped no downlink bytes, quantized shipping costing more than
    full-width fp, or admission sheds with a silent alert stream."""
    bytes_down = summary.get("downloaded_bytes",
                             summary.get("downloaded_MB", 0.0))
    if summary.get("model_updates", 0) > 0 and bytes_down == 0:
        raise ValueError(
            f"{name}/{scheme}: model_updates="
            f"{summary['model_updates']} but zero downlink bytes — model "
            f"updates that never crossed the downlink")
    fp_down = summary.get("downlink_fp_bytes")
    if fp_down is not None and bytes_down > fp_down:
        raise ValueError(
            f"{name}/{scheme}: downloaded_bytes={bytes_down} exceeds the "
            f"fp-equivalent reference downlink_fp_bytes={fp_down} — "
            f"quantized shipping cannot cost more than full-width fp")
    if summary.get("shed_queries", 0) > 0 \
            and summary.get("alerts_total", 0) == 0:
        raise ValueError(
            f"{name}/{scheme}: shed_queries={summary['shed_queries']} but "
            f"alerts_total=0 — admission shed queries without publishing "
            f"alert events")


def validate(name: str, scheme: str, report) -> None:
    """Empty or NaN metrics make the JSON artifact meaningless: die loudly."""
    if report.n_items == 0:
        sys.exit(f"FAIL {name}/{scheme}: pipeline answered zero items")
    s = report.summary()
    bad = [k for k, v in s.items()
           if isinstance(v, (int, float)) and not math.isfinite(v)]
    if bad:
        sys.exit(f"FAIL {name}/{scheme}: non-finite metrics {bad}")
    try:
        check_consistency(name, scheme, s)
    except ValueError as e:
        sys.exit(f"FAIL {e}")


def compact_query_row(row: dict) -> dict:
    """Per-query JSON row with the per-edge payloads summarized to counts
    (the gate compares only the scalar metrics)."""
    out = {k: v for k, v in row.items()
           if k not in ("live_edges", "thresholds")}
    if "live_edges" in row:
        out["n_live_edges"] = len(row["live_edges"])
    if "thresholds" in row:
        out["n_threshold_rows"] = len(row["thresholds"])
    return out


def variants(sc):
    """``[(row label, scenario), ...]``: the four schemes plus the
    ablation rows this scenario's knobs call for."""
    out = [(s, sc.with_scheme(s)) for s in SCHEMES]
    if sc.update_period_s is not None:
        out.append(("surveiledge_no_update", dataclasses.replace(
            sc.with_scheme("surveiledge"), update_period_s=None)))
    if sc.quantize_downlink or sc.speculative_escalation:
        out.append(("surveiledge_fp_wire", dataclasses.replace(
            sc.with_scheme("surveiledge"), quantize_downlink=False,
            speculative_escalation=False)))
    return out


def run_scenario(name: str, cameras: int, duration: float, seed: int,
                 device: str, json_out: str = None,
                 frontend: PixelFrontend = None) -> dict:
    """Simulate one scenario under every scheme (+ ablation rows); print
    the table, optionally write its JSON report, and return the report.

    A ``PIXEL_SCENARIOS`` preset runs on ``frontend``, by default
    ``PixelFrontend(seed=seed, device=device)``; pass one built with other
    weights (``params=``) to score with them.  The frontend caches its
    stream, so the frames are rendered and scored once for all rows."""
    sc = SCENARIOS[name](num_cameras=cameras, duration_s=duration, seed=seed)
    if name in PIXEL_SCENARIOS:
        frontend_name = "pixel"
        if frontend is None:
            frontend = PixelFrontend(seed=seed, device=device)
        stream = frontend.stream(sc)
    elif frontend is not None:
        raise ValueError(f"{name} runs on the confidence stream; frontend= "
                         f"is for {PIXEL_SCENARIOS}")
    else:
        frontend_name = "confidence"
        stream = synthetic_confidence_stream(sc)
    print(f"\n== {name} [{frontend_name}, {device}] — {len(stream)} "
          f"detections, "
          f"{sc.num_edges} edge(s) + cloud, {len(sc.query_ids)} "
          f"quer{'y' if len(sc.query_ids) == 1 else 'ies'} ==")
    print(f"{'scheme':22s}{'F2':>8s}{'avg_lat':>9s}{'p99':>9s}"
          f"{'WAN_MB':>8s}{'LAN_MB':>8s}{'DL_MB':>7s}{'upd':>5s}"
          f"{'escal':>7s}{'flip':>7s}{'rerouted':>9s}{'launches':>9s}"
          f"{'l/tick':>7s}")
    per_scheme = {}
    for label, variant in variants(sc):
        if frontend is not None:
            r = run_query(variant, frontend=frontend, device=device)
        else:
            r = run_query(variant, items=stream, device=device)
        if json_out:
            validate(name, label, r)
        s = r.summary()
        per_scheme[label] = {
            **s, "n_items": r.n_items,
            "accuracy_timeline": r.accuracy_timeline(),
            "stage_timings": {k: round(v, 4)
                              for k, v in r.stage_timings.items()}}
        if r.queries:
            per_scheme[label]["queries"] = {
                str(q): compact_query_row(row)
                for q, row in r.per_query_summary().items()}
        print(f"{label:22s}{s['accuracy_F2']:8.3f}"
              f"{s['avg_latency_s']:9.3f}{s['p99_latency_s']:9.3f}"
              f"{s['bandwidth_MB']:8.2f}{s['lan_MB']:8.2f}"
              f"{s['downloaded_MB']:7.2f}{s['model_updates']:5d}"
              f"{s['escalated']:7d}{s['reconciliation_flip_rate']:7.3f}"
              f"{s['rerouted']:9d}{s['kernel_launches']:9d}"
              f"{s['launches_per_tick']:7.2f}")
    doc = {"scenario": name, "frontend": frontend_name,
           "n_detections": len(stream), "num_edges": sc.num_edges,
           "schemes": per_scheme}
    if json_out:
        os.makedirs(json_out, exist_ok=True)
        path = os.path.join(json_out, f"{name}-{frontend_name}.json")
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2)
        print(f"   -> {path}")
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", choices=sorted(PORTED_SCENARIOS) + ["all"],
                    default=None,
                    help="run one ported scenario, or 'all' for every "
                         "ported preset with its smoke overrides (default: "
                         "the small-fleet sweep, city_scale left out)")
    ap.add_argument("--json-out", metavar="DIR", default=None,
                    help="write per-scenario JSON reports to DIR and fail "
                         "on NaN/empty/inconsistent metrics")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) runs the kernels on the card; "
                         "'cpu' runs their plain PyTorch versions")
    ap.add_argument("--cameras", type=int, default=6)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.scenario == "all":
        for name in sorted(PORTED_SCENARIOS):
            ov = SMOKE_OVERRIDES.get(name, {})
            run_scenario(name, ov.get("cameras", args.cameras),
                         ov.get("duration", args.duration), args.seed,
                         args.device, args.json_out)
        return
    names = [args.scenario] if args.scenario else \
        [n for n in sorted(PORTED_SCENARIOS) if n != "city_scale"]
    for name in names:
        run_scenario(name, args.cameras, args.duration, args.seed,
                     args.device, args.json_out)


if __name__ == "__main__":
    main()
