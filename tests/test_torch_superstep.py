"""The port's scan superstep against the reference and against itself.

Mirrors ``tests/test_superstep.py`` on the port: ``superstep=K`` must be
bit-exact against the ``superstep=1`` per-tick driver (and, for the fixed
scheme, against ``superstep=None``), and the metropolis preset must buy
its >= 10x host-loop reduction.  Beside that: ``superstep_torch`` (the
plain version the CPU runs and the CUDA kernel is held against) must equal
the reference's ``_superstep_fn`` bit for bit on seeded slabs, and the
port's metropolis smoke run must give the reference's report.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.system as R
from repro.system.superstep import _superstep_fn
from repro_torch.kernels import superstep as SS
from repro_torch.system import (
    SCENARIOS,
    city_scale,
    drifting_city,
    metropolis,
    multi_query_city,
    run_query,
)

# summary keys that legitimately differ between segmentations of the same
# run: one fused launch replaces many per-tick launches
_LAUNCH_KEYS = ("kernel_launches", "launches_per_tick", "supersteps")
#: the metropolis smoke size: the >= 1024-edge fleet over 12 s
_METRO = dict(num_cameras=1024, duration_s=12.0)


def _strip_launch_keys(summary):
    return {k: v for k, v in summary.items() if k not in _LAUNCH_KEYS}


def _assert_bit_exact(ra, rb):
    """Everything observable except the launch accounting is identical."""
    np.testing.assert_array_equal(ra.latencies, rb.latencies)
    np.testing.assert_array_equal(ra.decisions, rb.decisions)
    np.testing.assert_array_equal(ra.truths, rb.truths)
    np.testing.assert_array_equal(ra.finish_times, rb.finish_times)
    np.testing.assert_array_equal(ra.query_ids, rb.query_ids)
    assert ra.thresholds == rb.thresholds
    assert ra.queries == rb.queries
    assert _strip_launch_keys(ra.summary()) == _strip_launch_keys(
        rb.summary())


def _pair(base, ka, kb):
    return (run_query(dataclasses.replace(base, superstep=ka), device="cpu"),
            run_query(dataclasses.replace(base, superstep=kb), device="cpu"))


# --- the plain version vs the reference's fused program -----------------------


def _slab(seed, S, R, N, mask_kind="random"):
    """A seeded superstep input: confidences with pad lanes, start
    thresholds, a tick mask, drains on both sides of the interval."""
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0.0, 1.0, (S, R, N)).astype(np.float32)
    lengths = rng.integers(0, N + 1, (S, R))
    conf[np.arange(N)[None, None, :] >= lengths[..., None]] = -1.0
    th0 = np.stack([rng.uniform(0.5, 1.0, R), rng.uniform(0.0, 0.45, R)],
                   axis=1).astype(np.float32)
    mask = {"random": rng.uniform(0, 1, (S, R)) < 0.6,
            "off": np.zeros((S, R), bool),
            "on": np.ones((S, R), bool)}[mask_kind]
    interval = 0.1
    drain = rng.uniform(0.0, 3.0 * interval, R).astype(np.float32)
    drain[: R // 4] = interval                       # exactly at the gate
    gains = np.asarray([0.05, 0.2, 0.3, interval], np.float32)
    return conf, th0, mask, drain, gains


@pytest.mark.parametrize("S,R,N,capacity,mask_kind", [
    (1, 1, 8, 8, "random"),
    (2, 16, 8, 8, "random"),
    (16, 256, 8, 4, "random"),
    (5, 64, 8, 8, "on"),
    (3, 32, 32, 2, "off"),
    (7, 8, 40, 3, "on"),
])
def test_superstep_torch_matches_reference_program(S, R, N, capacity,
                                                   mask_kind):
    """Bit for bit: routes and slots (integers) and the f32 thresholds —
    the reference's scan rounds every f32 operation on its own, and so
    must the plain version."""
    conf, th0, mask, drain, gains = _slab(S * 1000 + R, S, R, N, mask_kind)
    want = [np.asarray(a) for a in _superstep_fn(capacity, 1)(
        conf, th0, mask, drain, gains)]
    got = SS.superstep_torch(*(torch.from_numpy(a) for a in
                               (conf, th0, mask, drain, gains)),
                             capacity=capacity)
    for g, w, what in zip(got, want, ("routes", "slots", "ths")):
        assert g.numpy().dtype == w.dtype, what
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)


def test_superstep_wrapper_on_the_cpu_is_the_plain_version():
    conf, th0, mask, drain, gains = (torch.from_numpy(a) for a in
                                     _slab(3, 4, 16, 8))
    before = SS.LAUNCHES
    got = SS.superstep(conf, th0, mask.to(torch.uint8), drain, gains,
                       capacity=4)
    want = SS.superstep_torch(conf, th0, mask, drain, gains, capacity=4)
    assert SS.LAUNCHES == before           # a CPU call never counts
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_superstep_wrapper_checks_its_inputs():
    conf, th0, mask, drain, gains = (torch.from_numpy(a) for a in
                                     _slab(4, 2, 8, 8))
    with pytest.raises(ValueError, match="mask"):
        SS.superstep(conf, th0, mask[:1], drain, gains, capacity=4)
    with pytest.raises(TypeError, match="float32"):
        SS.superstep(conf.double(), th0, mask, drain, gains, capacity=4)
    with pytest.raises(TypeError, match="mask"):
        SS.superstep(conf, th0, mask.float(), drain, gains, capacity=4)


# --- differential: K=1 reference vs K=N fused, per preset ---------------------


def test_city_scale_superstep_bit_exact():
    base = city_scale(duration_s=6.0, num_failures=2, interval_s=0.25)
    ra, rb = _pair(base, 1, 16)
    _assert_bit_exact(ra, rb)
    assert rb.supersteps < ra.supersteps  # fusion actually happened


def test_multi_query_city_superstep_bit_exact():
    base = multi_query_city(duration_s=30.0)
    ra, rb = _pair(base, 1, 25)
    _assert_bit_exact(ra, rb)
    assert rb.supersteps < ra.supersteps


def test_drifting_city_superstep_bit_exact():
    """Calibration deliveries are boundaries: the fused run splits at each
    one, so rows see exactly the calibration the per-tick driver applied."""
    base = drifting_city(duration_s=30.0)
    ra, rb = _pair(base, 1, 10)
    _assert_bit_exact(ra, rb)
    assert rb.model_updates == ra.model_updates > 0


def test_fixed_scheme_superstep_matches_true_legacy():
    """``surveiledge_fixed`` never refreshes thresholds and never sheds,
    so ``superstep=K`` equals ``superstep=None``, the per-tick loop."""
    base = multi_query_city(duration_s=30.0).with_scheme(
        "surveiledge_fixed")
    _assert_bit_exact(*_pair(base, None, 16))


@pytest.mark.parametrize("name,kw,k", [
    ("city_scale", dict(duration_s=6.0, num_failures=2, interval_s=0.25),
     16),
    ("drifting_city", dict(duration_s=30.0), 10),
])
def test_superstep_runs_match_the_reference(name, kw, k):
    want = R.run_query(dataclasses.replace(R.SCENARIOS[name](**kw),
                                           superstep=k))
    got = run_query(dataclasses.replace(SCENARIOS[name](**kw), superstep=k),
                    device="cpu")
    assert got.summary() == want.summary()
    assert got.thresholds == want.thresholds


# --- metropolis: scale smoke + determinism + parity ---------------------------


@pytest.fixture(scope="module")
def metro_report():
    """One smoke-size metropolis run shared by the scale assertions."""
    return run_query(metropolis(**_METRO), device="cpu")


def test_metropolis_host_loop_reduction(metro_report):
    """One fused launch per boundary-free run replaces >= 10 per-tick
    host-loop iterations, and launches never exceed triaged ticks."""
    r = metro_report
    assert r.supersteps > 0
    assert r.triaged_ticks / r.supersteps >= 10.0
    assert r.kernel_launches <= r.triaged_ticks
    assert r.summary()["launches_per_tick"] <= 1.0


def test_metropolis_streams_report_aggregates(metro_report):
    r = metro_report
    assert len(r.latencies) == 0 and len(r.decisions) == 0
    assert r.stream is not None and r.n_items == r.stream.n > 0
    assert 0.0 < r.summary()["accuracy_F2"] <= 1.0
    rows = r.accuracy_timeline()
    assert rows and sum(row["n"] for row in rows) == r.n_items
    per_q = r.per_query_summary()
    assert len(per_q) >= 12
    assert sum(row["n_items"] for row in per_q.values()) == r.n_items


def test_metropolis_determinism_same_seed(metro_report):
    again = run_query(metropolis(**_METRO), device="cpu")
    assert again.summary() == metro_report.summary()
    assert again.per_query_summary() == metro_report.per_query_summary()
    assert again.accuracy_timeline() == metro_report.accuracy_timeline()
    assert again.thresholds == metro_report.thresholds


def test_metropolis_matches_the_reference(metro_report):
    want = R.run_query(R.metropolis(**_METRO))
    assert metro_report.summary() == want.summary()
    assert metro_report.per_query_summary() == want.per_query_summary()
    assert metro_report.accuracy_timeline() == want.accuracy_timeline()
    assert metro_report.thresholds == want.thresholds


def test_metropolis_superstep_one_matches_the_preset(metro_report):
    """K=1 (a launch a triaged tick) against the preset's K=128."""
    one = run_query(metropolis(superstep=1, **_METRO), device="cpu")
    assert one.supersteps == one.triaged_ticks > metro_report.supersteps
    assert _strip_launch_keys(one.summary()) == _strip_launch_keys(
        metro_report.summary())
    assert one.per_query_summary() == metro_report.per_query_summary()
    assert one.accuracy_timeline() == metro_report.accuracy_timeline()
    assert one.thresholds == metro_report.thresholds


def test_shard_fleet_is_one_launch_on_one_device(metro_report):
    solo = run_query(metropolis(shard_fleet=False, **_METRO), device="cpu")
    assert solo.summary() == metro_report.summary()
    assert solo.thresholds == metro_report.thresholds
