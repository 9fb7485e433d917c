"""The port's feedback loop vs the reference: drifting_city and
multi_query_city, where the calibrate kernel runs.

Calibration params are floats: the port's plain f32 Newton fit and the
reference's f32 Pallas fit can differ by ulps (exp/log across libraries),
and the params then pass through the int8 downlink codec before they move
any route.  So each summary must be either identical to the reference's
or differ only in metrics that ``benchmarks/report_gate.py`` bands, each
within its band; every other key (counts of escalations, launches,
updates, bytes) must match exactly.  On the seeds below the summaries
come out identical, and the tests say so when they do.
"""
import dataclasses
import functools
import os
import sys

import pytest

import repro.system as R
import repro_torch.system as P
from repro_torch.bridge import items_from_records, scenario_from_fields
from repro_torch.kernels import calibrate as C
from repro_torch.kernels import triage as T

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))
from report_gate import TOLERANCES, compare_rows  # noqa: E402

PRESETS = ("drifting_city", "multi_query_city")
KW = dict(num_cameras=8, duration_s=30.0)
ROWS = R.SCHEMES + ("surveiledge_no_update", "surveiledge_fp_wire")


def _variant(sc, row):
    """The scenario behind one report row (``run_scenarios`` labels)."""
    if row == "surveiledge_no_update":
        return dataclasses.replace(sc.with_scheme("surveiledge"),
                                   update_period_s=None)
    if row == "surveiledge_fp_wire":
        return dataclasses.replace(sc.with_scheme("surveiledge"),
                                   quantize_downlink=False,
                                   speculative_escalation=False)
    return sc.with_scheme(row)


@functools.lru_cache(maxsize=None)
def _ref_stream(name):
    sc = R.SCENARIOS[name](**KW)
    return sc, R.synthetic_confidence_stream(sc)


@functools.lru_cache(maxsize=None)
def _pair(name, row):
    sc, items = _ref_stream(name)
    sc = _variant(sc, row)
    want = R.run_query(sc, items=items).summary()
    psc = scenario_from_fields(dataclasses.asdict(sc))
    pitems = items_from_records(dataclasses.asdict(it) for it in items)
    return P.run_query(psc, items=pitems, device="cpu").summary(), want


def assert_identical_or_within_gate(got, want):
    """Returns "identical" or "within report-gate bands"; fails otherwise."""
    assert set(got) == set(want)
    differing = {k for k in want if got[k] != want[k]}
    if not differing:
        return "identical"
    unbanded = differing - set(TOLERANCES)
    assert not unbanded, {k: (got[k], want[k]) for k in unbanded}
    assert not compare_rows(want, got, TOLERANCES)
    return "within report-gate bands"


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("name", PRESETS)
def test_summary_matches_reference(name, row, record_property):
    got, want = _pair(name, row)
    record_property("parity", assert_identical_or_within_gate(got, want))
    loop_on = row in ("surveiledge", "surveiledge_fixed",
                      "surveiledge_fp_wire")
    assert (got["model_updates"] > 0) == loop_on


@pytest.mark.parametrize("name", PRESETS)
def test_closed_loop_beats_open_loop(name):
    closed, _ = _pair(name, "surveiledge")
    opened, _ = _pair(name, "surveiledge_no_update")
    assert closed["accuracy_F2"] > opened["accuracy_F2"]
    assert closed["downloaded_bytes"] > 0 and opened["model_updates"] == 0


def test_feedback_stage_fits_on_the_run_device():
    """One ops.calibrate_fleet call per update event; on the CPU no kernel
    launch is claimed."""
    sc = P.drifting_city(**KW)
    launches = (T.LAUNCHES, C.LAUNCHES)
    rep = P.run_query(sc, device="cpu")
    assert rep.model_updates > 0
    assert (T.LAUNCHES, C.LAUNCHES) == launches
