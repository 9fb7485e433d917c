"""Inputs shared by the port's CPU tests and their cuda-marked twins.

The association cases are the greedy orders that the association
kernel's shortcuts (take the precomputed best while it is unclaimed,
rescan otherwise) must not change; the superstep cases cover every row
width the superstep kernel packs into a warp and the chunk walk beyond
32 lanes; the triage and calibrate widths cover every path of those two
kernels.  Plain numpy: ``tests/test_torch_cuda.py`` imports no JAX.
"""
import numpy as np

_EYE = np.eye(4, dtype=np.float32).tolist()


def _case(trk, emb, cq, tq, thr, want):
    return (np.asarray(emb, np.float32), np.asarray(trk, np.float32),
            np.asarray(cq, np.int32), np.asarray(tq, np.int32),
            np.asarray(thr, np.float32), want)


#: name -> (emb, trk, crop_q, trk_q, thr, the plain version's assign)
ASSOC_CASES = {
    # crop 0 claims track 0; crop 1's best is also track 0, so it rescans
    # and takes its next best, track 1
    "rescan_after_claim": _case(
        _EYE, [[1, 0, 0, 0], [0.9, 0.4, 0.1, 0]], [0, 0], [0, 0, 0, 0],
        [0.0, 0.0], [0, 1]),
    # five crops chase track 0 with falling scores: each takes the next
    # free track, and the fifth finds every track claimed
    "chain_contends_for_one_track": _case(
        _EYE, [[1, 0.5 - 0.1 * i, 0.3 - 0.1 * i, 0.05] for i in range(5)],
        [0] * 5, [0] * 4, [-0.5] * 5, [0, 1, 2, 3, -1]),
    # tracks 1 and 2 tie for crop 1 only once crop 0 has taken track 0:
    # the lower index wins
    "tie_only_after_claim": _case(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 1, 0, 0]],
        [[1, 0, 0, 0], [0.8, 0.6, 0, 0], [0.8, 0.6, 0, 0]], [0, 0, 0],
        [0, 0, 0], [0.5, 0.5, 0.5], [0, 1, 2]),
    # query 3 owns no track: crop 0 resolves at once, claiming nothing
    "query_without_tracks": _case(
        _EYE, [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0]], [3, 1, 0],
        [0, 0, 1, 1], [-0.9, -0.9, -0.9], [-1, 2, 1]),
    # every track masked and a floor below NEG_INF: the first maximum,
    # track 0, matches at NEG_INF and is claimed, so crop 1, whose best it
    # was, rescans
    "all_masked_floor_below_neg_inf": _case(
        _EYE, [[1, 0, 0, 0], [1, 0.5, 0, 0]], [5, 0], [0, 0, 0, 0],
        [-2e30, 0.0], [0, 1]),
}

#: (S, R, N, capacity, mask kind): N = 1, 3, 16 and 32 pack 32, 8, 2 and
#: 1 rows a warp, N = 33 and 64 walk 32-lane chunks; R is not a multiple
#: of the rows a warp packs, and S is odd
SUPERSTEP_WIDTH_CASES = [
    (7, 101, 1, 1, "random"),
    (9, 37, 3, 2, "random"),
    (5, 203, 16, 4, "on"),
    (3, 66, 32, 8, "random"),
    (5, 19, 33, 3, "random"),
    (3, 66, 64, 40, "on"),
    (33, 1021, 8, 8, "random"),
]


def superstep_slab(seed, S, R, N, mask_kind="random"):
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


#: triage widths: one to four of a row's lanes a lane (N <= 128: each
#: V = ceil(N/32), on the vector loads at 64 and 128 and the scalar ones
#: elsewhere) and the chunk walk (200, 1024), with widths off the buckets
#: (13, 21, 33, 200) as ``ops.triage`` passes them; and row counts from
#: one row to 2^17
TRIAGE_WIDTHS = [1, 2, 3, 8, 13, 16, 21, 32, 33, 64, 80, 100, 128, 200,
                 1024]
TRIAGE_ROWS = [1, 7, 64, 1 << 17]
#: calibrate widths on both of its kernel's paths: a warp a row up to 256
#: lanes (the feedback window; 100 and 200 off the powers of two), a
#: block a row up to ``MAX_LANES``
CALIBRATE_WIDTHS = [8, 16, 64, 100, 200, 256, 257, 2048]


def triage_case(seed, rows, n):
    """Seeded (conf (rows, n), thresholds (rows, 2)): NaN in row 0's
    first three lanes (where n allows) and, past one row, an all-pad last
    row."""
    rng = np.random.default_rng(seed)
    conf = rng.random((rows, n), dtype=np.float32)
    if n >= 3:
        conf[0, :3] = np.nan
    if rows > 1:
        conf[-1] = -1.0
    thr = np.stack([rng.uniform(0.5, 1.0, rows), rng.uniform(0.0, 0.45, rows)],
                   axis=1).astype(np.float32)
    return conf, thr


def label_case(seed, rows, n):
    """Seeded (scores, truths) of ``rows`` >= 4 rows from a known logistic,
    ragged, with degenerate rows: row 1 has four labels (below a
    ``min_count`` of 8), row 2 one class only, the last row no label."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.02, 0.98, (rows, n))
    p = 1.0 / (1.0 + np.exp(-(2.0 * np.log(s / (1 - s)) + 0.5)))
    truths = (rng.uniform(0, 1, (rows, n)) < p).astype(np.float32)
    lengths = rng.integers(max(1, n // 4), n + 1, rows)
    lengths[1], lengths[-1] = min(4, n), 0
    truths[2] = 1.0
    lane = np.arange(n)[None, :]
    scores = np.where(lane < lengths[:, None], s, -1.0).astype(np.float32)
    truths = np.where(lane < lengths[:, None], truths, 0.0).astype(np.float32)
    return scores, truths

#: (B, H, W) of ``chip_smoke.PIXEL_SHAPES``: the default camera frame, a
#: sub-band height, non-lane widths
PIXEL_SHAPES = [(2, 96, 128), (1, 33, 40), (3, 16, 300), (2, 100, 96),
                (1, 64, 129)]
#: (B, H, W) of ``chip_smoke.PIXEL_TILE_SHAPES``: the cascade's 28 x 16
#: and 60 x 32 tiles (the latter from 32,768 pixels a frame) and the
#: stencil's 128 x 16, at exact multiples and one past them, W * 3 odd
PIXEL_TILE_SHAPES = [(2, 16, 28), (1, 17, 29), (3, 33, 57), (2, 16, 128),
                     (1, 17, 257), (1, 128, 256), (2, 161, 241),
                     (1, 96, 600)]


def pixel_batch(seed, B, H, W):
    """A (B, 3, H, W, 3) uint8 batch of three random frames a camera, as
    the renderer hands ``detect`` its frames."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, 3, H, W, 3)).astype(np.uint8)
