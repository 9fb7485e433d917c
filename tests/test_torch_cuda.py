"""The port's CUDA wrappers on the card: launch counters, refusals, and
short runs.  ``chip_smoke.py`` holds each kernel against its plain version
at the edge-case and main-path shapes; this file does not repeat that.

Every test here needs a CUDA device and carries the ``cuda`` marker; on a
host without one they skip.  The file imports nothing of JAX or the
reference package, so it also runs on a GPU machine that has neither:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.system as P
from repro_torch.kernels import calibrate as C
from repro_torch.kernels import similarity as SIM
from repro_torch.kernels import superstep as SS
from repro_torch.kernels import triage as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _fleet(seed, rows, n):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0, 1, (rows, n)).astype(np.float32)
    conf[0] = -1.0                                   # an all-pad row
    thr = np.stack([rng.uniform(0.5, 1.0, rows), rng.uniform(0.0, 0.45, rows)],
                   axis=1).astype(np.float32)
    return torch.from_numpy(conf), torch.from_numpy(thr)


def _labels(seed, lengths, n):
    rng = np.random.default_rng(seed)
    scores = np.full((len(lengths), n), -1.0, np.float32)
    truths = np.zeros((len(lengths), n), np.float32)
    for e, length in enumerate(lengths):
        s = rng.uniform(0.02, 0.98, length)
        p = 1.0 / (1.0 + np.exp(-(2.0 * np.log(s / (1 - s)) + 0.5)))
        scores[e, :length] = s
        truths[e, :length] = rng.uniform(0, 1, length) < p
    return torch.from_numpy(scores), torch.from_numpy(truths)


def _slab(seed, S, R, N):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0, 1, (S, R, N)).astype(np.float32)
    th0 = np.stack([rng.uniform(0.5, 1.0, R), rng.uniform(0.0, 0.45, R)],
                   axis=1).astype(np.float32)
    mask = rng.uniform(0, 1, (S, R)) < 0.6
    drain = rng.uniform(0.0, 0.3, R).astype(np.float32)
    gains = np.asarray([0.05, 0.2, 0.3, 0.1], np.float32)
    return [torch.from_numpy(a) for a in (conf, th0, mask, drain, gains)]


def _problem(seed, m, k, d):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(m, d)).astype(np.float32)
    trk = rng.normal(size=(k, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    trk /= np.maximum(np.linalg.norm(trk, axis=1, keepdims=True), 1e-12)
    cq = rng.integers(0, 2, m).astype(np.int32)
    tq = rng.integers(0, 2, k).astype(np.int32)
    thr = np.full(m, -0.5, np.float32)
    return [torch.from_numpy(a) for a in (emb, trk, cq, tq, thr)]


def test_each_launch_counts_once(cuda):
    conf, thr = (t.to(cuda) for t in _fleet(0, 8, 16))
    before = T.LAUNCHES
    T.triage_fleet(conf, thr, capacity=4)
    T.triage_fleet_torch(conf, thr, capacity=4)
    assert T.LAUNCHES == before + 1
    s, t = (x.to(cuda) for x in _labels(0, [64, 0], 64))
    before = C.LAUNCHES
    C.calibrate_fleet(s, t, iters=8, min_count=8)
    C.calibrate_fleet_torch(s, t, iters=8, min_count=8)
    assert C.LAUNCHES == before + 1
    slab = [x.to(cuda) for x in _slab(0, 5, 64, 8)]
    before = SS.LAUNCHES
    SS.superstep(*slab, capacity=3)
    SS.superstep_torch(*slab, capacity=3)
    assert SS.LAUNCHES == before + 1
    problem = [x.to(cuda) for x in _problem(1, 16, 16, 32)]
    before = SIM.LAUNCHES
    SIM.associate(*problem)
    SIM.associate_torch(*problem)
    assert SIM.LAUNCHES == before + 1


def test_cuda_tensors_never_fall_back(cuda):
    conf, thr = (t.to(cuda) for t in _fleet(0, 8, 16))
    with pytest.raises(ValueError, match="contiguous"):
        T.triage_fleet(conf.t().contiguous().t(), thr, capacity=4)
    s, t = (x.to(cuda) for x in _labels(0, [10], C.MAX_LANES * 2))
    with pytest.raises(ValueError, match="lanes"):
        C.calibrate_fleet(s, t, iters=8, min_count=8)
    conf, th0, mask, drain, gains = (x.to(cuda) for x in _slab(0, 2, 8, 8))
    with pytest.raises(ValueError, match="empty"):
        SS.superstep(conf[:0], th0, mask[:0], drain, gains, capacity=3)
    emb, _, cq, _, thr = (x.to(cuda) for x in _problem(0, 8, 0, 8))
    trk = torch.zeros((SIM.MAX_TRACKS * 2, 8), device=cuda)
    tq = torch.zeros(len(trk), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tracks"):
        SIM.associate(emb, trk, cq, tq, thr)


@pytest.mark.parametrize("name,kw", [
    ("city_scale", dict(duration_s=5.0)),
    ("drifting_city", dict(num_cameras=8, duration_s=30.0)),
    ("multi_query_city", dict(num_cameras=8, duration_s=30.0)),
])
def test_run_on_card_counts_every_launch(cuda, name, kw):
    sc = P.SCENARIOS[name](**kw)
    T.LAUNCHES = C.LAUNCHES = 0
    got = P.run_query(sc, device="cuda").summary()
    assert T.LAUNCHES == got["kernel_launches"] > 0
    assert C.LAUNCHES == got["model_updates"]
    assert (got["model_updates"] > 0) == (sc.update_period_s is not None)
    want = P.run_query(sc, device="cpu").summary()
    if sc.update_period_s is None:
        assert got == want          # integer kernel outputs only
    else:
        # float Platt params: the same function, f32 sums in another order
        assert got["model_updates"] == want["model_updates"]
        assert abs(got["accuracy_F2"] - want["accuracy_F2"]) <= 0.05


@pytest.mark.parametrize("name,kw", [
    ("metropolis", dict(num_cameras=1024, duration_s=6.0)),
    ("vehicle_pursuit", dict(duration_s=20.0)),
])
def test_superstep_and_track_runs_on_card(cuda, name, kw):
    sc = P.SCENARIOS[name](**kw)
    SS.LAUNCHES = SIM.LAUNCHES = 0
    rep = P.run_query(sc, device="cuda")
    got = rep.summary()
    assert SS.LAUNCHES == rep.supersteps
    assert SIM.LAUNCHES == rep.track_launches
    assert SS.LAUNCHES + SIM.LAUNCHES > 0
    assert got == P.run_query(sc, device="cpu").summary()
