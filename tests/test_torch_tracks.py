"""The port's cross-camera track queries against the reference.

Mirrors ``tests/test_track_query.py`` on the port: the association's
plain version and its bucket-padding wrapper against the reference's
kernel (interpret mode) and its NumPy oracle, the greedy one-to-one and
query-mask invariants, the one-fused-launch-per-tick budget, the
predictive hand-off beating its ablation, the mixed-query preset, the
track table dying with its query — and, end to end, the port's summary
equal to the reference's on both track presets under every report row.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.system as R
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch import run_scenarios as RS
from repro_torch.kernels import ops
from repro_torch.kernels import similarity as SIM
from repro_torch.system import (SCENARIOS, crowd_flow, run_query,
                                single_edge, vehicle_pursuit)
from torch_kernel_cases import ASSOC_CASES

#: sim tolerance, plain version vs reference: the same f32 dots summed in
#: another order (torch's CPU matmul vs XLA's)
SIM_ATOL = 1e-5


def _rand_problem(rng, m, k, d, nq=2):
    emb = rng.normal(size=(m, d)).astype(np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    trk = rng.normal(size=(k, d)).astype(np.float32)
    trk /= np.maximum(np.linalg.norm(trk, axis=1, keepdims=True), 1e-12)
    cq = rng.integers(0, nq, m).astype(np.int32)
    tq = rng.integers(0, nq, k).astype(np.int32)
    thr = rng.uniform(-0.5, 0.9, m).astype(np.float32)
    return emb, trk, cq, tq, thr


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --- the association against the reference -------------------------------------


@pytest.mark.parametrize("m,k,d", [(5, 7, 16), (1, 1, 4), (16, 16, 32),
                                   (9, 30, 20), (33, 3, 8)])
def test_associate_matches_the_reference(m, k, d):
    rng = np.random.default_rng(m * 100 + k)
    problem = _rand_problem(rng, m, k, d)
    ap, sp = (np.asarray(a) for a in ref_ops.associate_tracks(*problem))
    ar, sr = ref.associate_tracks_ref(*problem)
    for assign, sim in (
            ops.associate_tracks(*problem, device="cpu"),
            SIM.associate_torch(*_tensors(*problem))):
        np.testing.assert_array_equal(assign.numpy(), ap)
        np.testing.assert_array_equal(assign.numpy(), ar)
        np.testing.assert_allclose(sim.numpy(), sp, rtol=SIM_ATOL,
                                   atol=SIM_ATOL)
        np.testing.assert_allclose(sim.numpy(), sr, rtol=SIM_ATOL,
                                   atol=SIM_ATOL)


def test_associate_empty_table_and_empty_crops():
    rng = np.random.default_rng(0)
    emb, trk, cq, tq, thr = _rand_problem(rng, 4, 6, 8)
    a, s = ops.associate_tracks(emb, trk[:0], cq, tq[:0], thr, device="cpu")
    assert torch.all(a == -1) and torch.all(s == SIM.NEG_INF)
    a2, _ = ops.associate_tracks(emb[:0], trk, cq[:0], tq, thr[:0],
                                 device="cpu")
    assert tuple(a2.shape) == (0,)
    a3, s3 = SIM.associate_torch(*_tensors(emb, trk[:0], cq, tq[:0], thr))
    assert torch.all(a3 == -1) and torch.all(s3 == SIM.NEG_INF)


def test_associate_greedy_one_to_one_and_query_mask():
    rng = np.random.default_rng(7)
    emb, trk, cq, tq, thr = _rand_problem(rng, 24, 10, 16, nq=3)
    a, s = ops.associate_tracks(emb, trk, cq, tq, thr, device="cpu")
    a, s = a.numpy(), s.numpy()
    claimed = a[a >= 0]
    assert len(claimed) == len(set(claimed)), "a track claimed twice"
    for i, j in enumerate(a):
        if j >= 0:
            assert cq[i] == tq[j], "association crossed query boundaries"
            assert s[i] >= thr[i] - 1e-6


def test_associate_prefers_best_available():
    # two crops chase the same track: the earlier crop wins it, the later
    # one falls to its next-best (greedy in crop order)
    trk = np.eye(3, dtype=np.float32)
    emb = np.stack([trk[0], 0.9 * trk[0] + 0.1 * trk[1]]).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    a, _ = SIM.associate_torch(*_tensors(
        emb, trk, np.zeros(2, np.int32), np.zeros(3, np.int32),
        np.full(2, 0.05, np.float32)))
    assert a.tolist() == [0, 1]


def test_associate_tie_goes_to_the_lowest_index():
    """Two identical tracks score the same: the lower row wins, as
    ``argmax`` breaks ties, and the next crop takes the other."""
    trk = np.asarray([[0, 1, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]], np.float32)
    emb = np.asarray([[1, 0, 0, 0], [1, 0, 0, 0]], np.float32)
    problem = (emb, trk, np.zeros(2, np.int32), np.zeros(3, np.int32),
               np.full(2, 0.5, np.float32))
    a, s = ops.associate_tracks(*problem, device="cpu")
    assert a.tolist() == [1, 2] and s.tolist() == [1.0, 1.0]
    np.testing.assert_array_equal(
        np.asarray(ref_ops.associate_tracks(*problem)[0]), a.numpy())


def test_associate_all_masked_query():
    """A crop whose query owns no track sees only masked scores: no
    match, sim NEG_INF, and no track is claimed for the crops after it."""
    rng = np.random.default_rng(3)
    emb, trk, _, _, _ = _rand_problem(rng, 3, 5, 8)
    cq = np.asarray([5, 0, 0], np.int32)
    tq = np.zeros(5, np.int32)
    thr = np.asarray([-0.9, -0.9, -0.9], np.float32)
    a, s = ops.associate_tracks(emb, trk, cq, tq, thr, device="cpu")
    assert a[0] == -1 and bool(s[0] == SIM.NEG_INF)
    assert a[1] >= 0 and a[2] >= 0 and a[1] != a[2]


@pytest.mark.parametrize("name", sorted(ASSOC_CASES))
def test_associate_greedy_cases_match_the_reference(name):
    """The greedy orders the kernel's claim shortcuts rely on: a rescan
    after a claim, a chain contending for one track, a tie that appears
    only after a claim, a query without tracks, every track masked under
    a floor below NEG_INF.  The port's plain version and its wrapper
    against the reference's kernel (interpret mode) and its oracle."""
    *problem, want = ASSOC_CASES[name]
    ap, sp = (np.asarray(a) for a in ref_ops.associate_tracks(*problem))
    ar, sr = ref.associate_tracks_ref(*problem)
    np.testing.assert_array_equal(ap, want)
    np.testing.assert_array_equal(ar, want)
    for assign, sim in (
            ops.associate_tracks(*problem, device="cpu"),
            SIM.associate_torch(*_tensors(*problem))):
        np.testing.assert_array_equal(assign.numpy(), want)
        np.testing.assert_allclose(sim.numpy(), sp, rtol=SIM_ATOL,
                                   atol=SIM_ATOL)
        np.testing.assert_allclose(sim.numpy(), sr, rtol=SIM_ATOL,
                                   atol=SIM_ATOL)


def test_associate_many_crop_tiles_match_the_reference():
    """1,024 crops against 128 tracks: a score matrix the kernel splits
    into several shared-memory tiles of crop rows, whose claims carry from
    tile to tile."""
    rng = np.random.default_rng(11)
    problem = _rand_problem(rng, 1024, 128, 32)
    ap, sp = (np.asarray(a) for a in ref_ops.associate_tracks(*problem))
    assign, sim = SIM.associate_torch(*_tensors(*problem))
    np.testing.assert_array_equal(assign.numpy(), ap)
    np.testing.assert_allclose(sim.numpy(), sp, rtol=SIM_ATOL,
                               atol=SIM_ATOL)
    assert (assign >= 0).sum() == 128    # every track taken, most crops not


def test_associate_wrapper_on_the_cpu_does_not_count():
    rng = np.random.default_rng(1)
    problem = _tensors(*_rand_problem(rng, 8, 8, 8))
    before = SIM.LAUNCHES
    got = SIM.associate(*problem)
    want = SIM.associate_torch(*problem)
    assert SIM.LAUNCHES == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(TypeError, match="int32"):
        SIM.associate(problem[0], problem[1], problem[2].long(),
                      problem[3], problem[4])


# --- end-to-end track runs on the port ------------------------------------------


def _pursuit(duration_s=25.0, **kw):
    return vehicle_pursuit(duration_s=duration_s, **kw)


def test_vehicle_pursuit_tracks_end_to_end():
    s = run_query(_pursuit(), device="cpu").summary()
    assert s["track_items"] > 0
    assert s["tracks_born"] > 0
    assert s["track_matches"] > 0
    assert 0.0 <= s["track_continuity"] <= 1.0
    assert s["track_launches_per_tick"] <= 1.0 + 1e-9


def test_track_association_one_fused_launch_per_tick(monkeypatch):
    calls = {"n": 0}
    orig = ops.associate_tracks

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    import repro_torch.system.tracks as TK
    monkeypatch.setattr(TK.ops, "associate_tracks", counting)
    r = run_query(_pursuit(), device="cpu")
    assert calls["n"] == r.track_launches > 0
    assert r.track_launches <= r.ticks


def test_handoff_beats_no_handoff_ablation():
    sc = vehicle_pursuit()
    on = run_query(sc, device="cpu")
    off = run_query(dataclasses.replace(sc, predictive_handoff=False),
                    device="cpu")
    assert on.prewarms_shipped > 0 and on.track_handoffs > 0
    assert on.prewarm_hits > 0
    assert off.prewarms_shipped == 0
    assert on.id_switches < off.id_switches
    assert on.track_continuity > off.track_continuity


def test_handoff_decisions_deterministic_across_reruns():
    a = run_query(_pursuit(), device="cpu")
    b = run_query(_pursuit(), device="cpu")
    assert a.summary() == b.summary()
    np.testing.assert_array_equal(a.latencies, b.latencies)


def test_crowd_flow_mixes_track_and_classify():
    r = run_query(crowd_flow(duration_s=20.0), device="cpu")
    s = r.summary()
    assert s["n_queries"] == 2
    assert s["track_items"] > 0
    assert s["track_items"] < r.n_items


def test_track_table_dies_with_query_retire():
    sc = crowd_flow(duration_s=20.0)
    specs = tuple(dataclasses.replace(sp, t_retire_s=8.0)
                  if sp.kind == "track" else sp for sp in sc.queries)
    r = run_query(dataclasses.replace(sc, queries=specs), device="cpu")
    assert 0 < r.track_items < run_query(sc, device="cpu").track_items


def test_classify_presets_carry_no_track_columns():
    s = run_query(single_edge(duration_s=15.0), device="cpu").summary()
    assert not any(k.startswith(("track", "id_switch", "prewarm"))
                   for k in s), s


# --- end to end against the reference, every report row ----------------------------

#: the track presets at a duration the tier-1 budget holds; at 20 s
#: ``vehicle_pursuit`` still lands pre-warm hits (asserted below)
_TRACK_DURATION = 20.0


def _ref_variant(name, label):
    sc = R.SCENARIOS[name](duration_s=_TRACK_DURATION)
    if label == "surveiledge_no_handoff":
        return dataclasses.replace(sc.with_scheme("surveiledge"),
                                   predictive_handoff=False)
    return sc.with_scheme(label)


@pytest.mark.parametrize("name", ["vehicle_pursuit", "crowd_flow"])
def test_track_presets_match_the_reference_under_every_row(name):
    rows = RS.variants(SCENARIOS[name](duration_s=_TRACK_DURATION))
    assert [label for label, _ in rows][-1] == "surveiledge_no_handoff"
    for label, sc in rows:
        got = run_query(sc, device="cpu")
        want = R.run_query(_ref_variant(name, label))
        assert got.summary() == want.summary(), (name, label)
        assert got.accuracy_timeline() == want.accuracy_timeline()
        if name == "vehicle_pursuit" and label == "surveiledge":
            assert got.prewarm_hits > 0
