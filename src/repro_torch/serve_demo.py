"""Live query submission against the real-time driver.

The same engine that runs the discrete-event scenarios runs as a
*serving process*: an ``AsyncDriver`` pumps the event heap from asyncio,
and a client submits continuous queries mid-run through ``QueryAPI`` —
each submission rides the full control plane (per-tenant token-bucket
quota, fine-tune-backlog shedding by priority tier, Fig. 5 cloud
fine-tune, per-edge weight shipment) before the fleet starts answering
it.  Triage runs on ``--device`` (the card by default).

Two clocks:

  * default (virtual): deterministic, finishes instantly — bit-identical
    to the discrete-event ``SimDriver``;
  * ``--wall --speed N``: real time, N simulated seconds per wall second
    (~duration/N wall seconds).

  PYTHONPATH=src python -m repro_torch.serve_demo --device cpu
  PYTHONPATH=src python -m repro_torch.serve_demo --wall --speed 100

Exits non-zero if the top priority tier breaches its SLO or if admission
never sheds a query: the property the ``rush_hour`` preset is built
around.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

from repro_torch.serving.api import QueryAPI
from repro_torch.serving.engine import AsyncDriver, VirtualClock, WallClock
from repro_torch.system import QueryPipeline, QueryReport, QuerySpec, rush_hour
from repro_torch.system.scenario import synthetic_confidence_stream


def run_demo(*, cameras: int = 4, duration_s: float = 40.0, seed: int = 0,
             wall: bool = False, speed: float = 100.0, device="cuda"
             ) -> Tuple[QueryReport, AsyncDriver, QueryAPI, List[QuerySpec]]:
    """``rush_hour`` under an ``AsyncDriver`` with the live submissions
    made through ``QueryAPI`` at their arrival times: (report, driver,
    api, live queries)."""
    sc = rush_hour(num_cameras=cameras, duration_s=duration_s, seed=seed)
    driver = AsyncDriver(WallClock(speed) if wall else VirtualClock())
    pipe = QueryPipeline(sc, driver=driver, device=device)
    api = QueryAPI(pipe)
    # live submissions on top of the scenario's declared query book: a
    # priority customer onboarding mid-rush (tier 0: backlog-exempt, so
    # it trains even while the flood queues) and one more best-effort
    # straggler (tier 2: sheds against the by-then-deep backlog)
    d = duration_s
    live = [QuerySpec(100, t_arrive_s=d * 0.35, train_scheme="surveiledge",
                      tenant="metro-pd", tier=0),
            QuerySpec(101, t_arrive_s=d * 0.45, train_scheme="surveiledge",
                      tenant="hobby", tier=2)]
    for sp in live:
        driver.call_at(sp.t_arrive_s, lambda t, sp=sp: api.submit(t, sp))
    return pipe.run(synthetic_confidence_stream(sc)), driver, api, live


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--duration", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wall", action="store_true",
                    help="run on the wall clock instead of virtual time")
    ap.add_argument("--speed", type=float, default=100.0,
                    help="simulated seconds per wall second (with --wall)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    report, driver, api, live = run_demo(
        cameras=args.cameras, duration_s=args.duration, seed=args.seed,
        wall=args.wall, speed=args.speed, device=args.device)

    print(f"== serve_demo [{'wall' if args.wall else 'virtual'} clock] — "
          f"{driver.events_pumped} events pumped, "
          f"{driver.hooks_run} live submissions ==")
    for sp in live:
        print(f"  live query {sp.query} (tenant={sp.tenant}, "
              f"tier={sp.tier}): {api.status(sp.query)}")
    s = report.summary()
    print(f"  submitted={s['submitted_queries']} "
          f"shed={s['shed_queries']} shed_rate={s['shed_rate']}")
    print(f"  alerts: {report.alerts}")
    for k, row in sorted(report.tier_latency.items()):
        print(f"  tier {k}: n={row['n']} "
              f"p99={row['p99_latency_s']:.3f}s "
              f"slo={row['slo_s']:.1f}s breaches={row['slo_breaches']}")
    top = min(report.tier_latency)
    if report.tier_latency[top]["slo_breaches"] > 0:
        print("FAIL: top-priority tier breached its SLO", file=sys.stderr)
        return 1
    if s["shed_queries"] == 0:
        print("FAIL: rush hour shed nothing — admission never engaged",
              file=sys.stderr)
        return 1
    print("OK: top tier held its SLO while lower tiers shed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
