"""``python -m repro_torch.serve_demo`` against the reference's
``examples/serve_demo.py``, on the CPU.

Under the virtual clock the demo is deterministic: its report (summary,
tier latencies, alerts, the live queries' statuses) must equal the
reference's for the same flags exactly, and its printout must be the
reference's line for line.  Both exit checks (the top tier holds its SLO,
admission sheds) must pass.
"""
import runpy
import sys
from pathlib import Path

import pytest
import torch

import repro.system as R
from repro.serving.api import QueryAPI as RQueryAPI
from repro.serving.engine import AsyncDriver as RAsyncDriver
from repro.serving.engine import VirtualClock as RVirtualClock
from repro.system.scenario import synthetic_confidence_stream as ref_stream
from repro_torch import serve_demo

ROOT = Path(__file__).resolve().parents[1]


def _reference_demo(cameras=4, duration_s=40.0, seed=0):
    """The reference demo's run, step for step (its ``main`` keeps the
    report to itself)."""
    sc = R.rush_hour(num_cameras=cameras, duration_s=duration_s, seed=seed)
    driver = RAsyncDriver(RVirtualClock())
    pipe = R.QueryPipeline(sc, driver=driver)
    api = RQueryAPI(pipe)
    d = duration_s
    live = [R.QuerySpec(100, t_arrive_s=d * 0.35, train_scheme="surveiledge",
                        tenant="metro-pd", tier=0),
            R.QuerySpec(101, t_arrive_s=d * 0.45, train_scheme="surveiledge",
                        tenant="hobby", tier=2)]
    for sp in live:
        driver.call_at(sp.t_arrive_s, lambda t, sp=sp: api.submit(t, sp))
    return pipe.run(ref_stream(sc)), driver, api, live


@pytest.mark.parametrize("cameras,duration_s,seed", [(4, 40.0, 0),
                                                      (6, 30.0, 3)])
def test_virtual_clock_report_equals_reference(cameras, duration_s, seed):
    want, rdriver, rapi, rlive = _reference_demo(cameras, duration_s, seed)
    got, driver, api, live = serve_demo.run_demo(
        cameras=cameras, duration_s=duration_s, seed=seed, device="cpu")
    assert got.summary() == want.summary()
    assert got.tier_latency == want.tier_latency
    assert got.alerts == want.alerts
    assert [(sp.query, sp.t_arrive_s, sp.tenant, sp.tier) for sp in live] \
        == [(sp.query, sp.t_arrive_s, sp.tenant, sp.tier) for sp in rlive]
    assert [api.status(sp.query) for sp in live] == \
        [rapi.status(sp.query) for sp in rlive]
    assert (driver.events_pumped, driver.hooks_run) == \
        (rdriver.events_pumped, rdriver.hooks_run) and driver.hooks_run == 2


def test_printout_and_exit_checks_equal_the_reference(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve_demo.py"])
    runpy.run_path(str(ROOT / "examples" / "serve_demo.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    assert serve_demo.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[-1].startswith("OK: top tier held its SLO")


def test_wall_clock_gives_the_virtual_clocks_report():
    virtual = serve_demo.run_demo(duration_s=10.0, device="cpu")[0]
    wall = serve_demo.run_demo(duration_s=10.0, wall=True, speed=400.0,
                               device="cpu")[0]
    assert wall.summary() == virtual.summary()


def test_a_failed_check_exits_non_zero_as_the_reference(monkeypatch,
                                                        capsys):
    """A 2 s rush hour fails a check: the same one on both sides."""
    monkeypatch.setattr(sys, "argv", ["serve_demo.py", "--duration", "2"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_path(str(ROOT / "examples" / "serve_demo.py"),
                       run_name="__main__")
    want = capsys.readouterr().out
    assert str(exc.value.code).startswith("FAIL:")
    assert serve_demo.main(["--duration", "2", "--device", "cpu"]) == 1
    got = capsys.readouterr()
    assert got.out == want
    assert got.err.strip() == exc.value.code


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_demo.main([])
