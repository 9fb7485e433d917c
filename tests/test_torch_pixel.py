"""The port's pixel path end to end against the reference's: frames ->
pixel cascade -> CCL -> crops -> CQ scores -> Item stream -> run_query ->
report, on the CPU (the kernels' plain versions; the reference's Pallas
kernels in interpret mode).

The reference draws its CQ weights from a JAX PRNG key, which torch
cannot reproduce, so the stream-parity checks score with the reference's
own ``PixelFrontend(seed=0).params`` carried across through numpy
(``bridge.cq_params_from_numpy``).  Every integer field of the stream must
then be identical and ``conf`` within ``CONF_ATOL`` = 1e-5 (f32 on both
sides, summed in another order; the largest gap seen is below 1e-7).

The committed ``reports/pixel_city-pixel.json`` was scored with the
weights that ``PRNGKey(0)`` gave under JAX's earlier default PRNG mode
(``jax_threefry_partitionable=False``; the default flipped in JAX 0.5).
Under today's default the reference's own report misses that baseline
on ``edge_only`` F2, so the gate test bridges the baseline's weights,
drawn with that flag set for the one call.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.models import meta as JM
from repro.system import PixelFrontend as RefPixelFrontend
from repro.system import pixel_city as ref_pixel_city
from repro.system import run_query as ref_run_query
from repro_torch import bridge
from repro_torch import run_scenarios as RS
from repro_torch.data import synthetic_video as SV
from repro_torch.detection.components import Box
from repro_torch.system import PixelFrontend, pixel_city, run_query
from repro_torch.system.pixel_frontend import match_truth

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
from report_gate import compare_report  # noqa: E402

CONF_ATOL = 1e-5
#: the stream-parity scenario: small enough for tier-1, busy enough to
#: give several classifier launches
PARITY = dict(num_cameras=4, num_edges=2, duration_s=5.0, seed=0)
INT_FIELDS = ("t_arrival", "camera", "edge_device", "is_query", "nbytes")


@pytest.fixture(scope="module")
def ref_run():
    """The reference's frontend, its stream on ``PARITY`` and its
    weights bridged into the port."""
    fe = RefPixelFrontend(seed=0)
    items = fe.stream(ref_pixel_city(**PARITY))
    params = bridge.cq_params_from_numpy(jax.tree.map(np.asarray, fe.params))
    return fe, items, params


def test_stream_matches_reference(ref_run):
    ref_fe, ref_items, params = ref_run
    fe = PixelFrontend(params=params, device="cpu")
    items = fe.stream(pixel_city(**PARITY))
    assert len(items) == len(ref_items) > 0
    for got, want in zip(items, ref_items):
        assert [getattr(got, f) for f in INT_FIELDS] == \
            [getattr(want, f) for f in INT_FIELDS]
        assert got.emb is None and want.emb is None
    dconf = max(abs(g.conf - w.conf) for g, w in zip(items, ref_items))
    assert dconf <= CONF_ATOL, dconf
    assert fe.launches == ref_fe.launches > 0


def test_summary_identical_on_reference_items(ref_run):
    """The pipeline behind the frontend, fed the reference's own stream
    (carried across as plain records), gives the reference's summary."""
    ref_fe, ref_items, _ = ref_run
    items = bridge.items_from_records(
        dataclasses.asdict(it) for it in ref_items)
    for scheme in ("surveiledge", "edge_only"):
        got = run_query(pixel_city(**PARITY).with_scheme(scheme),
                        items=items, device="cpu").summary()
        want = ref_run_query(ref_pixel_city(**PARITY).with_scheme(scheme),
                             frontend=ref_fe).summary()
        assert got == want, scheme


def test_pixel_city_report_passes_gate(ref_run, tmp_path):
    """The port's runner at the committed baseline's settings (``make
    bench-smoke``: 4 cameras, the 10 s smoke override), scoring with the
    baseline's weights, passes the report gate."""
    ref_fe = ref_run[0]
    with jax.threefry_partitionable(False):
        tree = JM.init_params(ref_fe.cfg, jax.random.PRNGKey(0))
    params = bridge.cq_params_from_numpy(jax.tree.map(np.asarray, tree))
    ov = RS.SMOKE_OVERRIDES["pixel_city"]
    fe = PixelFrontend(params=params, device="cpu")
    RS.run_scenario("pixel_city", ov.get("cameras", 4), ov["duration"], 0,
                    "cpu", str(tmp_path), frontend=fe)
    fresh = json.loads((tmp_path / "pixel_city-pixel.json").read_text())
    base = json.loads((ROOT / "reports" / "pixel_city-pixel.json")
                      .read_text())
    assert compare_report(base, fresh) == []
    assert fresh["n_detections"] == base["n_detections"]
    assert set(fresh["schemes"]) == set(base["schemes"])
    for row, want in base["schemes"].items():
        assert set(fresh["schemes"][row]) == set(want)
    with pytest.raises(ValueError, match="confidence stream"):
        RS.run_scenario("single_edge", 2, 2.0, 0, "cpu", frontend=fe)


# --- truth matching -----------------------------------------------------------


def test_match_truth_picks_nearest_sprite_and_rejects_noise():
    truth = SV.FrameTruth(classes=[3, 7], boxes=[(10, 10), (60, 90)])
    on_moped = Box(8, 8, 28, 28, 441)        # center (18, 18) ~ sprite 0
    on_dog = Box(58, 88, 78, 108, 441)       # center (68, 98) ~ sprite 1
    far = Box(0, 60, 10, 70, 121)            # matches nothing
    assert match_truth(on_moped, truth) == 3
    assert match_truth(on_dog, truth) == 7
    assert match_truth(far, truth) is None


# --- the frontend -------------------------------------------------------------


def test_static_scene_yields_zero_items():
    """No moving objects -> no motion mask -> empty stream."""
    sc = pixel_city(num_cameras=2, duration_s=3.0, burst_rate=0.0,
                    burst_boost=0.0)
    fe = PixelFrontend(seed=0, device="cpu")
    assert fe.stream(sc) == []
    assert fe.launches == 0


def test_pixel_frontend_items_are_well_formed():
    sc = pixel_city(num_cameras=3, num_edges=2, duration_s=4.0, seed=1)
    fe = PixelFrontend(seed=1, device="cpu")
    items = fe.stream(sc)
    assert len(items) > 0
    t = [it.t_arrival for it in items]
    assert t == sorted(t) and 0 <= t[0] and t[-1] < sc.duration_s
    for it in items:
        assert 0.0 <= it.conf <= 1.0
        assert it.edge_device in sc.edge_ids
        assert 0 <= it.camera < sc.num_cameras
        assert it.edge_device == it.camera % sc.num_edges + 1
        assert it.nbytes == fe.crop * fe.crop * 3
    assert fe.timings["render_s"] > 0
    assert fe.timings["framediff_s"] > 0
    assert fe.timings["classify_s"] > 0


def test_staged_chain_gives_the_fused_stream():
    sc = pixel_city(num_cameras=2, num_edges=2, duration_s=3.0, seed=4)
    fused = PixelFrontend(seed=4, device="cpu").stream(sc)
    staged = PixelFrontend(seed=4, fused=False, device="cpu").stream(sc)
    assert staged == fused and len(fused) > 0


def test_pixel_frontend_stream_cache_reuses_render():
    sc = pixel_city(num_cameras=2, duration_s=3.0, seed=2)
    fe = PixelFrontend(seed=2, device="cpu")
    first = fe.stream(sc)
    launches = fe.launches
    assert fe.stream(sc) == first             # same scenario -> cache hit
    assert fe.launches == launches
    # a scheme change must hit, a stream-shaping change must miss
    assert fe.stream(sc.with_scheme("edge_only")) == first
    assert fe.launches == launches
    other = fe.stream(dataclasses.replace(sc, seed=9))
    assert fe.launches > launches
    assert other != first
    uncached = PixelFrontend(seed=2, cache=False, device="cpu")
    uncached.stream(sc)
    n = uncached.launches
    uncached.stream(sc)
    assert uncached.launches == 2 * n > 0


def test_run_query_pixel_report_has_stage_timings():
    """frames -> triage -> allocation -> metrics: the report carries the
    frontend's stage timings next to the engine's triage timing."""
    sc = pixel_city(num_cameras=4, num_edges=2, duration_s=5.0, seed=0)
    fe = PixelFrontend(seed=0, device="cpu")
    r = run_query(sc, frontend=fe, device="cpu")
    assert len(r.latencies) == len(fe.stream(sc)) > 0
    for stage in ("render_s", "framediff_s", "classify_s", "triage_s"):
        assert r.stage_timings[stage] > 0, stage
    assert r.kernel_launches > 0
    r_conf = run_query(sc, device="cpu")
    assert "framediff_s" not in r_conf.stage_timings
    assert "triage_s" in r_conf.stage_timings


def test_pixel_frontend_refuses_items():
    with pytest.raises(ValueError, match="pixel"):
        run_query(pixel_city(num_cameras=2, duration_s=2.0),
                  frontend="pixel", items=[], device="cpu")
