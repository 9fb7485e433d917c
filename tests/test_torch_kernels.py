"""PyTorch port kernels vs the JAX reference.

Triage: the port's plain version and ``ops`` wrappers against the
reference's Pallas path (interpret mode, as the reference's own tests run
it) and its jnp oracle — integer outputs must be exactly equal.  Platt
fit: against the float64 NumPy oracle at the reference test's
``rtol=atol=1e-3``, and against the reference's f32 Pallas fit at
``atol=1e-4`` (exp/log differ by ulps across libraries and 8 Newton steps
carry them forward); counts exactly.  Inputs come from fixed numpy seeds.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import buckets
from repro_torch.kernels import calibrate as C
from repro_torch.kernels import ops, runtime
from repro_torch.kernels import triage as T
from torch_kernel_cases import (CALIBRATE_WIDTHS, TRIAGE_ROWS, TRIAGE_WIDTHS,
                                label_case, triage_case)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


def _fleet(seed, lead, n, pad_rows=(), lengths=None):
    """conf (*lead, n) with ragged right-padding and all-pad rows, plus
    per-row thresholds [alpha, beta]."""
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0, 1, (*lead, n)).astype(np.float32)
    flat = conf.reshape(-1, n)
    if lengths is not None:
        for r, length in enumerate(lengths):
            flat[r, length:] = -1.0
    for r in pad_rows:
        flat[r] = -1.0
    thr = np.stack([rng.uniform(0.5, 1.0, lead), rng.uniform(0.0, 0.45, lead)],
                   axis=-1).astype(np.float32)
    return conf, thr


# --- triage -------------------------------------------------------------------


@pytest.mark.parametrize("rows,n,capacity", [(7, 33, 8), (64, 32, 64),
                                             (8, 64, 3)])
def test_triage_fleet_torch_matches_ref_fleet(rows, n, capacity):
    conf, thr = _fleet(rows * n, (rows,), n)
    got = T.triage_fleet_torch(torch.from_numpy(conf), torch.from_numpy(thr),
                               capacity=capacity)
    _assert_equal(got, ref.triage_fleet_ref(conf, thr, capacity))
    assert all(g.dtype == torch.int32 for g in got)


@pytest.mark.parametrize("E,n,capacity", [(5, 13, 4), (3, 9, 64), (9, 17, 2),
                                          (1, 1, 1)])
def test_ops_triage_fleet_2d_matches_pallas(E, n, capacity):
    """Ragged E and N exercise both pads; small capacities overflow."""
    conf, thr = _fleet(E + n, (E,), n, lengths=[n - i % n for i in range(E)])
    got = ops.triage_fleet(conf, thr, capacity=capacity, device="cpu")
    _assert_equal(got, jops.triage_fleet(conf, thr, capacity=capacity))
    assert tuple(got[0].shape) == (E, n) and tuple(got[2].shape) == (E,)


@pytest.mark.parametrize("Q", [1, 2, 3])
def test_ops_triage_fleet_3d_fold_matches_pallas(Q):
    E, n = 5, 11
    conf, thr = _fleet(Q, (Q, E), n, pad_rows=[1, Q * E - 1],
                       lengths=[n - (i % 4) for i in range(Q * E)])
    got = ops.triage_fleet(conf, thr, capacity=3, device="cpu")
    want = jops.triage_fleet(conf, thr, capacity=3)
    _assert_equal(got, want)
    _assert_equal(got, ref.triage_fleet_ref(conf, thr, 3))
    assert tuple(got[0].shape) == (Q, E, n)


def test_triage_capacity_overflow_counts_every_escalation():
    conf = np.full((2, 40), 0.5, np.float32)          # all escalate
    thr = np.asarray([[0.9, 0.1], [0.9, 0.1]], np.float32)
    routes, slots, counts = ops.triage_fleet(conf, thr, capacity=6,
                                             device="cpu")
    assert (_np(routes) == 2).all()
    np.testing.assert_array_equal(_np(slots)[0, :6], np.arange(6))
    assert (_np(slots)[:, 6:] == -1).all()
    np.testing.assert_array_equal(_np(counts), [40, 40])


def test_triage_pad_rows_and_lanes_are_inert():
    conf, thr = _fleet(4, (4,), 10, pad_rows=[2], lengths=[10, 3, 10, 7])
    routes, slots, counts = ops.triage_fleet(conf, thr, capacity=8,
                                             device="cpu")
    routes, slots = _np(routes), _np(slots)
    assert (routes[2] == 1).all() and (slots[2] == -1).all()
    assert int(_np(counts)[2]) == 0
    assert (routes[1, 3:] == 1).all() and (slots[1, 3:] == -1).all()


@pytest.mark.parametrize("N,alpha,beta", [(1, 0.8, 0.1), (13, 0.7, 0.2),
                                          (64, 0.9, 0.05)])
def test_triage_one_row_matches_pallas(N, alpha, beta):
    conf = np.random.default_rng(N).uniform(0, 1, N).astype(np.float32)
    _assert_equal(ops.triage(conf, alpha=alpha, beta=beta, capacity=5,
                             device="cpu"),
                  jops.triage(conf, alpha=alpha, beta=beta, capacity=5))
    got = ops.triage_batched(conf, alpha=alpha, beta=beta, capacity=5,
                             device="cpu")
    _assert_equal(got, jops.triage_batched(conf, alpha=alpha, beta=beta,
                                           capacity=5))
    assert tuple(got[0].shape) == (N,) and got[2].ndim == 0


@pytest.mark.parametrize("rows", [r for r in TRIAGE_ROWS if r <= 64])
@pytest.mark.parametrize("n", TRIAGE_WIDTHS)
def test_triage_fleet_torch_matches_ref_at_every_kernel_width(n, rows):
    """The plain version the kernel is held to on the card, against the
    reference's oracle at every width of the kernel's three paths, with
    NaN lanes, an all-pad row, capacity 0 and overflow."""
    conf, thr = triage_case(rows * 1000 + n, rows, n)
    for capacity in (0, max(1, n // 4), n):
        got = T.triage_fleet_torch(torch.from_numpy(conf),
                                   torch.from_numpy(thr), capacity=capacity)
        _assert_equal(got, ref.triage_fleet_ref(conf, thr, capacity))


def test_triage_nan_escalates_like_the_reference():
    conf = np.asarray([[np.nan, 0.95, 0.02, 0.5]], np.float32)
    thr = np.asarray([[0.9, 0.1]], np.float32)
    got = ops.triage_fleet(conf, thr, capacity=4, device="cpu")
    _assert_equal(got, ref.triage_fleet_ref(conf, thr, 4))
    np.testing.assert_array_equal(_np(got[0]), [[2, 0, 1, 2]])


# --- calibrate ----------------------------------------------------------------


def _label_fleet(seed, lengths, n=None, a=2.0, b=0.5):
    """Per-row (scores, truths) from a known logistic: y ~ Bernoulli of
    sigmoid(a * logit(s) + b).  Pad lanes score -1.0, truth 0."""
    rng = np.random.default_rng(seed)
    n = n if n is not None else max(max(lengths), 1)
    scores = np.full((len(lengths), n), -1.0, np.float32)
    truths = np.zeros((len(lengths), n), np.float32)
    for e, length in enumerate(lengths):
        s = rng.uniform(0.02, 0.98, length)
        p = 1.0 / (1.0 + np.exp(-(a * np.log(s / (1 - s)) + b)))
        scores[e, :length] = s
        truths[e, :length] = rng.uniform(0, 1, length) < p
    return scores, truths


def _calibrate_torch(scores, truths, iters=8, min_count=8):
    p, c = C.calibrate_fleet_torch(torch.from_numpy(scores),
                                   torch.from_numpy(truths), iters=iters,
                                   min_count=min_count)
    return _np(p), _np(c)


@pytest.mark.parametrize("seed,lengths", [
    (0, [200, 150, 7, 40, 0]), (1, [256, 256, 31, 64]), (2, [12, 9, 100])])
def test_calibrate_fleet_torch_matches_numpy_oracle(seed, lengths):
    scores, truths = _label_fleet(seed, lengths)
    truths[-1, :lengths[-1]] = 1.0           # a single-class row
    got_p, got_c = _calibrate_torch(scores, truths)
    want_p, want_c = ref.calibrate_fleet_ref(scores, truths, 8, 8)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got_c, want_c)
    assert got_p.dtype == np.float32 and got_c.dtype == np.int32


@pytest.mark.parametrize("seed,lengths", [(3, [60, 33, 90]),
                                          (4, [256, 128, 17, 5, 0])])
def test_ops_calibrate_fleet_matches_pallas_f32(seed, lengths):
    scores, truths = _label_fleet(seed, lengths)
    got_p, got_c = ops.calibrate_fleet(scores, truths, device="cpu")
    want_p, want_c = jops.calibrate_fleet(scores, truths)
    np.testing.assert_allclose(_np(got_p), np.asarray(want_p), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(_np(got_c), np.asarray(want_c))


@pytest.mark.parametrize("n", CALIBRATE_WIDTHS)
def test_calibrate_fleet_torch_matches_pallas_at_every_kernel_width(n):
    """The plain version the kernel is held to on the card, against the
    reference's f32 Pallas fit at the widths of both of the kernel's
    paths, degenerate rows included."""
    scores, truths = label_case(n, 5, n)
    got_p, got_c = _calibrate_torch(scores, truths)
    want_p, want_c = jops.calibrate_fleet(scores, truths)
    np.testing.assert_allclose(got_p, np.asarray(want_p), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_c, np.asarray(want_c))
    for r in (1, 2, 4):
        np.testing.assert_array_equal(got_p[r], [1.0, 0.0])


def test_ops_calibrate_fleet_3d_fold_matches_pallas_f32():
    Q, E = 3, 4
    scores, truths = _label_fleet(5, [40 + 13 * i for i in range(Q * E)])
    n = scores.shape[1]
    s3, t3 = scores.reshape(Q, E, n), truths.reshape(Q, E, n)
    got_p, got_c = ops.calibrate_fleet(s3, t3, device="cpu")
    want_p, want_c = jops.calibrate_fleet(s3, t3)
    assert tuple(got_p.shape) == (Q, E, 2) and tuple(got_c.shape) == (Q, E)
    np.testing.assert_allclose(_np(got_p), np.asarray(want_p), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(_np(got_c), np.asarray(want_c))
    want64, _ = ref.calibrate_fleet_ref(s3, t3, 8, 8)
    np.testing.assert_allclose(_np(got_p), want64, rtol=1e-3, atol=1e-3)


def test_calibrate_degenerate_rows_are_exactly_identity():
    scores, truths = _label_fleet(6, [40, 4, 40, 0, 30])
    truths[2, :40] = 0.0                     # all-negative labels
    truths[4, :30] = 1.0                     # all-positive labels
    params, counts = ops.calibrate_fleet(scores, truths, min_count=8,
                                         device="cpu")
    params = _np(params)
    assert not np.allclose(params[0], [1.0, 0.0])     # healthy row fitted
    np.testing.assert_array_equal(params[1:], [[1.0, 0.0]] * 4)
    np.testing.assert_array_equal(_np(counts), [40, 4, 40, 0, 30])


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_calibrate_padding_is_invisible_against_oracle(seed):
    """Padding invariance judged against the float64 oracle on the
    UNPADDED rows (not against the reference's own padded result)."""
    rng = np.random.default_rng(seed)
    lengths = list(rng.integers(10, 120, 3))
    scores, truths = _label_fleet(seed, lengths)
    want_p, want_c = ref.calibrate_fleet_ref(scores, truths, 8, 8)
    wide = np.full((7, scores.shape[1] + 41), -1.0, np.float32)
    wide_t = np.zeros_like(wide)
    wide[:3, :scores.shape[1]] = scores
    wide_t[:3, :scores.shape[1]] = truths
    params, counts = ops.calibrate_fleet(wide, wide_t, device="cpu")
    params, counts = _np(params), _np(counts)
    np.testing.assert_allclose(params[:3], want_p, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(counts[:3], want_c)
    np.testing.assert_array_equal(params[3:], [[1.0, 0.0]] * 4)
    assert (counts[3:] == 0).all()


def test_calibrate_recovers_known_logistic():
    scores, truths = _label_fleet(10, [2048], a=2.0, b=0.5)
    params, _ = ops.calibrate_fleet(scores, truths, device="cpu")
    a, b = _np(params)[0]
    assert abs(a - 2.0) < 0.35 and abs(b - 0.5) < 0.35


# --- wrappers, counters, device rule --------------------------------------------


def test_empty_launch_takes_only_the_card():
    """The launch floor's empty kernel has no CPU version: a CPU device is
    refused, and it is never counted as a triage launch."""
    before = T.LAUNCHES
    with pytest.raises(ValueError, match="no kernel"):
        T.empty_launch(torch.device("cpu"))
    assert T.LAUNCHES == before


def test_cpu_calls_never_count_as_kernel_launches():
    t0, c0 = T.LAUNCHES, C.LAUNCHES
    conf, thr = _fleet(0, (4,), 8)
    ops.triage_fleet(conf, thr, capacity=4, device="cpu")
    scores, truths = _label_fleet(0, [20, 30])
    ops.calibrate_fleet(scores, truths, device="cpu")
    assert (T.LAUNCHES, C.LAUNCHES) == (t0, c0)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        T.triage_fleet(torch.zeros(2, 8, dtype=torch.float64),
                       torch.zeros(2, 2), capacity=1)
    with pytest.raises(ValueError):
        T.triage_fleet(torch.zeros(2, 8), torch.zeros(3, 2), capacity=1)
    with pytest.raises(TypeError):
        C.calibrate_fleet(torch.zeros(2, 8), torch.zeros(2, 8,
                                                         dtype=torch.int32),
                          iters=8, min_count=8)
    with pytest.raises(ValueError):
        C.calibrate_fleet(torch.zeros(2, 8), torch.zeros(2, 9), iters=8,
                          min_count=8)
    with pytest.raises(ValueError):
        runtime.resolve_device("meta")


def test_ops_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    conf, thr = _fleet(0, (2,), 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.triage_fleet(conf, thr, capacity=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.calibrate_fleet(*_label_fleet(0, [10]))


def test_build_is_hashed_by_source_and_flags():
    paths = {runtime.lib_path(k) for k in runtime.KERNELS}
    assert len(paths) == len(runtime.KERNELS)
    assert all(p.parent == runtime.BUILD_DIR for p in paths)
    assert runtime.lib_path("triage") == runtime.lib_path("triage")
    assert "sm_90a" in " ".join(runtime.NVCC_FLAGS)
    assert sorted(p.name for p in runtime.CSRC.glob("*.cu")) == \
        sorted(f"{k}.cu" for k in runtime.KERNELS)


def test_bucket_table_matches_reference():
    from repro.kernels import buckets as jb
    for n in (0, 1, 7, 8, 9, 33, 1000):
        assert buckets.bucket(n) == jb.bucket(n)
        assert buckets.bucket_q(n) == jb.bucket_q(n)
    assert buckets.MAX_FLEET_ROWS == jb.MAX_FLEET_ROWS == 1 << 17
    with pytest.raises(ValueError):
        buckets.validate_fleet_dims("x", 3, 1 << 16, 8)
