"""The port's asyncio driver against its discrete-event driver.

Mirrors the driver differential of ``tests/test_control_plane.py`` on the
port: ``AsyncDriver`` in virtual time pops the same event heap in the same
order as ``SimDriver``, so every decision, metric and byte counter is
identical; live submission through ``QueryAPI`` rides its hooks.  One
run under each driver is also held against the reference package.
"""
import asyncio
import time

import numpy as np
import pytest

import repro.system as R
from repro_torch.serving.api import QueryAPI
from repro_torch.serving.engine import AsyncDriver, VirtualClock, WallClock
from repro_torch.system import (
    QueryPipeline,
    QuerySpec,
    Scenario,
    city_scale,
    run_query,
    rush_hour,
    synthetic_confidence_stream,
    vehicle_pursuit,
)


def _reports_identical(a, b):
    assert a.summary() == b.summary()
    np.testing.assert_array_equal(a.latencies, b.latencies)
    np.testing.assert_array_equal(a.decisions, b.decisions)
    np.testing.assert_array_equal(a.truths, b.truths)
    np.testing.assert_array_equal(a.finish_times, b.finish_times)
    assert a.alerts == b.alerts
    assert a.tier_latency == b.tier_latency
    assert a.queries == b.queries


def _both(sc):
    return (run_query(sc, device="cpu"),
            run_query(sc, driver=AsyncDriver(VirtualClock()), device="cpu"))


def test_async_driver_bit_exact_city_scale():
    a, b = _both(city_scale(duration_s=6.0, num_failures=2, interval_s=0.25))
    _reports_identical(a, b)
    want = R.run_query(R.city_scale(duration_s=6.0, num_failures=2,
                                    interval_s=0.25))
    assert b.summary() == want.summary()


def test_async_driver_bit_exact_rush_hour():
    """The full control plane (admission, tiers, alerts) under both
    drivers: sheds, breach counts and alert streams all identical."""
    a, b = _both(rush_hour(duration_s=40.0, num_cameras=4))
    _reports_identical(a, b)
    assert a.shed_queries > 0 and a.alerts      # not a quiet run


def test_async_driver_bit_exact_vehicle_pursuit():
    """Track hand-offs are decided per tick from the same heap order, so
    the pre-warm shipments and ID switches are identical too."""
    a, b = _both(vehicle_pursuit(duration_s=25.0))
    _reports_identical(a, b)
    assert a.prewarms_shipped == b.prewarms_shipped > 0
    assert a.id_switches == b.id_switches


def test_async_driver_counts_its_pumps():
    sc = city_scale(duration_s=2.0, num_failures=0, interval_s=0.25)
    driver = AsyncDriver()
    pipe = QueryPipeline(sc, driver=driver, device="cpu")
    pipe.run(synthetic_confidence_stream(sc))
    assert isinstance(driver.clock, VirtualClock)
    assert driver.events_pumped > 0 and driver.hooks_run == 0
    assert driver.clock.now() > 0.0


def test_query_api_live_submission_virtual_time():
    sc = rush_hour(duration_s=40.0, num_cameras=4)
    driver = AsyncDriver(VirtualClock())
    pipe = QueryPipeline(sc, driver=driver, device="cpu")
    api = QueryAPI(pipe)
    top = QuerySpec(100, t_arrive_s=14.0, tenant="metro-pd", tier=0)
    low = QuerySpec(101, t_arrive_s=18.0, tenant="hobby", tier=2)
    driver.call_at(top.t_arrive_s, lambda t: api.submit(t, top))
    driver.call_at(low.t_arrive_s, lambda t: api.submit(t, low))
    r = pipe.run(synthetic_confidence_stream(sc))
    assert driver.hooks_run == 2
    assert api.status(100) == "live"
    assert api.status(101) == "shed"
    assert api.status(999) == "unknown"
    assert r.submitted_queries == len(sc.queries) + 2


def test_query_api_duplicate_and_retire():
    sc = rush_hour(duration_s=40.0, num_cameras=4)
    pipe = QueryPipeline(sc, driver=AsyncDriver(VirtualClock()),
                         device="cpu")
    api = QueryAPI(pipe)
    pipe.setup(synthetic_confidence_stream(sc))
    api.submit(0.0, QuerySpec(100, tenant="metro-pd", tier=0))
    with pytest.raises(ValueError, match="already registered"):
        api.submit(0.0, QuerySpec(100, tenant="metro-pd", tier=0))
    api.retire(5.0, 100)
    pipe.driver.drive(pipe)
    r = pipe.finalize()
    assert api.status(100) == "retired"
    assert r.submitted_queries == len(sc.queries) + 1


def test_runtime_track_query_submission_builds_the_track_stage():
    """A track query submitted at run time gets the fleet-wide track
    table the scenario did not declare."""
    pipe = QueryPipeline(city_scale(duration_s=2.0, num_failures=0),
                         device="cpu")
    pipe.setup([])
    assert pipe.track is None
    pipe.register_query(QuerySpec(7, kind="track"))
    assert pipe.track is not None and 7 in pipe._track_qs


def test_wall_clock_paces_real_time():
    clock = WallClock(speed=20.0)
    t0 = time.monotonic()
    asyncio.run(clock.sleep_until(2.0))
    assert time.monotonic() - t0 >= 0.05
    assert clock.now() >= 2.0
    with pytest.raises(ValueError, match="speed"):
        WallClock(speed=0.0)


def test_wall_clock_driver_matches_sim():
    sc = Scenario(name="tiny", edge_speeds=(1.0,), num_cameras=2,
                  duration_s=3.0)
    a = run_query(sc, device="cpu")
    b = run_query(sc, driver=AsyncDriver(WallClock(speed=500.0)),
                  device="cpu")
    _reports_identical(a, b)
