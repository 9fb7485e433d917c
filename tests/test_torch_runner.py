"""The port's scenario runner writes the reference report schema, and its
reports pass the report gate against the committed ``reports/``
baselines (built by ``examples/run_scenarios.py`` on the reference)."""
import json
import os
import sys
from pathlib import Path

import pytest

from repro_torch import run_scenarios as RS

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
from report_gate import compare_report  # noqa: E402


@pytest.mark.parametrize("name", ["single_edge", "drifting_city",
                                  "vehicle_pursuit"])
def test_port_report_passes_gate_against_baseline(tmp_path, name):
    ov = RS.SMOKE_OVERRIDES.get(name, {})
    RS.run_scenario(name, ov.get("cameras", 4), ov.get("duration", 30.0), 0,
                    "cpu", str(tmp_path))
    path = tmp_path / f"{name}-confidence.json"
    fresh = json.loads(path.read_text())
    base = json.loads((ROOT / "reports" / path.name).read_text())
    assert compare_report(base, fresh) == []
    assert set(fresh) == set(base)
    assert set(fresh["schemes"]) == set(base["schemes"])
    for row, want in base["schemes"].items():
        assert set(fresh["schemes"][row]) == set(want)


def test_runner_rows_follow_the_scenario_knobs():
    from repro_torch.system import (drifting_city, single_edge,
                                    vehicle_pursuit)
    assert [r for r, _ in RS.variants(single_edge())] == \
        ["surveiledge", "surveiledge_fixed", "edge_only", "cloud_only"]
    rows = [r for r, _ in RS.variants(drifting_city())]
    assert rows[-2:] == ["surveiledge_no_update", "surveiledge_fp_wire"]
    rows = [r for r, _ in RS.variants(vehicle_pursuit())]
    assert rows[-1] == "surveiledge_no_handoff"
    assert os.path.basename(RS.__file__) == "run_scenarios.py"
