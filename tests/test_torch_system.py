"""The port's query pipeline vs the reference, presets without feedback.

On every preset of the slice whose kernel outputs are all integers
(``update_period_s`` off: only the triage kernel runs), the port's
``run_query(..., device="cpu").summary()`` must be IDENTICAL to the
reference's, under all four schemes.  The port runs on exactly the stream
the reference consumed (rebuilt through ``repro_torch.bridge``), so a
failure here is pipeline divergence; stream parity is tested separately.
"""
import dataclasses
import functools

import pytest

import repro.system as R
import repro_torch.system as P
from repro_torch.bridge import items_from_records, scenario_from_fields
from repro_torch.kernels import calibrate as C
from repro_torch.kernels import triage as T

#: preset -> constructor overrides (city_scale keeps its pinned floors)
PRESETS = {
    "single_edge": dict(duration_s=20.0),
    "homogeneous_multi_edge": dict(duration_s=20.0),
    "heterogeneous_multi_edge": dict(duration_s=20.0),
    "bursty_crowds": dict(duration_s=20.0),
    "straggler_edge": dict(duration_s=30.0),
    "city_scale": dict(duration_s=5.0),
    "query_churn": dict(num_cameras=8, duration_s=30.0),
    "rush_hour": dict(num_cameras=4, duration_s=20.0),
}


@functools.lru_cache(maxsize=None)
def _ref_stream(name):
    sc = R.SCENARIOS[name](**PRESETS[name])
    return sc, R.synthetic_confidence_stream(sc)


def _bridged(sc, items):
    return (scenario_from_fields(dataclasses.asdict(sc)),
            items_from_records(dataclasses.asdict(it) for it in items))


@pytest.mark.parametrize("scheme", R.SCHEMES)
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_summary_identical_to_reference(name, scheme):
    sc, items = _ref_stream(name)
    sc = sc.with_scheme(scheme)
    want = R.run_query(sc, items=items).summary()
    psc, pitems = _bridged(sc, items)
    launches = (T.LAUNCHES, C.LAUNCHES)
    got = P.run_query(psc, items=pitems, device="cpu").summary()
    assert got == want
    # the CPU path runs the plain versions: no kernel launch is claimed,
    # while the pipeline still counts its fused triage calls
    assert (T.LAUNCHES, C.LAUNCHES) == launches
    if scheme.startswith("surveiledge"):
        assert got["kernel_launches"] > 0
        assert got["launches_per_tick"] <= 1.0
    assert got["model_updates"] == 0 and got["supersteps"] == 0


@pytest.mark.parametrize("name", ["single_edge", "city_scale", "query_churn",
                                  "rush_hour", "drifting_city",
                                  "multi_query_city"])
def test_synthetic_stream_identical_to_reference(name):
    kw = PRESETS.get(name, dict(num_cameras=8, duration_s=30.0))
    want = R.synthetic_confidence_stream(R.SCENARIOS[name](**kw))
    got = P.synthetic_confidence_stream(P.SCENARIOS[name](**kw))
    assert len(got) == len(want) > 0
    assert [dataclasses.asdict(it) for it in got] == \
        [dataclasses.asdict(it) for it in want]


def test_bridge_round_trips_nested_specs():
    sc = R.rush_hour(num_cameras=4, duration_s=20.0)
    psc, _ = _bridged(sc, [])
    assert dataclasses.asdict(psc) == dataclasses.asdict(sc)
    assert type(psc.queries[0]).__module__.startswith("repro_torch.")
    assert type(psc.tiers[0]).__module__.startswith("repro_torch.")
    injected = dataclasses.replace(sc, items=tuple(_ref_stream("rush_hour")[1]))
    pinj, _ = _bridged(injected, [])
    assert len(pinj.items) == len(injected.items)
    assert type(pinj.items[0]).__module__.startswith("repro_torch.")
    with pytest.raises(TypeError):
        scenario_from_fields({**dataclasses.asdict(sc), "bogus": 1})


def test_port_own_stream_gives_reference_summary():
    """No bridge: the port synthesizes its own stream from the seed."""
    kw = PRESETS["heterogeneous_multi_edge"]
    want = R.run_query(R.heterogeneous_multi_edge(**kw)).summary()
    got = P.run_query(P.heterogeneous_multi_edge(**kw), device="cpu")
    assert got.summary() == want
