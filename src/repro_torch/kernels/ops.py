"""Public wrappers for the port's kernels: padding, dtype and device.

Every wrapper takes a ``device``: ``"cuda"`` (the default) launches the
hand-written kernel on the card, ``"cpu"`` runs the kernel's plain
PyTorch version.  Inputs may be numpy arrays or tensors; padding happens
where the input lies (for numpy, on the host before one copy to the
device), and outputs come back as tensors on ``device``.

The bucket padding and pad sentinels are the reference's
(``kernels/buckets.py``): both trailing axes pad to power-of-two buckets
(min 8) and the query axis to ``bucket_q``; pad lanes carry conf/score
-1.0 (always 'reject', never a slot; masked out of every fit), pad triage
rows carry thresholds (1, 0), pad calibration rows truths 0, pad crop
rows token 0, pad crops query id -1 and threshold 2.0, pad tracks query
id -2.  The pads are sliced back off before returning, so padding
is invisible to callers exactly as in the reference.  The pixel kernels
take the true frame size and need no padding, and so does the attention
kernel, which masks the ragged key tile itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import buckets as _bk
from repro_torch.kernels import calibrate as _ca
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import framediff as _fd
from repro_torch.kernels import morphology as _mo
from repro_torch.kernels import pixel_cascade as _pc
from repro_torch.kernels import similarity as _sim
from repro_torch.kernels import triage as _tr
from repro_torch.kernels.runtime import resolve_device

#: [alpha, beta] of a pad triage row: nothing is > 1 and nothing is < 0
PAD_THRESHOLDS = (1.0, 0.0)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _pad_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """Append ``rows`` rows of ``fill`` (a scalar or a row) along axis 0."""
    if rows == 0:
        return x
    pad = torch.as_tensor(fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad.expand(rows, *x.shape[1:])])


def triage(conf, *, alpha: float, beta: float, capacity: int,
           device="cuda"):
    """(N,) confidences -> (routes (N,), slots (N,), count ()), static
    thresholds: the one-row launch of the fleet kernel."""
    dev = resolve_device(device)
    conf = _f32(conf).reshape(1, -1).to(dev).contiguous()
    thr = torch.tensor([[alpha, beta]], dtype=torch.float32, device=dev)
    routes, slots, counts = _tr.triage_fleet(conf, thr, capacity=capacity)
    return routes[0], slots[0], counts[0]


def triage_batched(conf, *, alpha: float, beta: float, capacity: int,
                   device="cuda"):
    """Per-tick batched triage with runtime thresholds.

    Pads N up to a power-of-two bucket (min 8) with conf=-1.0 (always
    'reject', never a slot or a count), launches once, and slices the pad
    back off."""
    conf = _f32(conf)
    (n,) = conf.shape
    conf = F.pad(conf, (0, _bk.bucket(n) - n), value=-1.0)
    routes, slots, count = triage(conf, alpha=alpha, beta=beta,
                                  capacity=capacity, device=device)
    return routes[:n], slots[:n], count


def triage_fleet(conf, thresholds, *, capacity: int, device="cuda"):
    """Whole-fleet per-tick triage: ONE kernel launch for every edge —
    and, with a query axis, for every live query on every edge.

    2D: ``conf`` (E, N) tick matrix, row e right-padded with -1.0 where
    edge e saw fewer than N detections, and ``thresholds`` (E, 2) per-edge
    runtime [alpha, beta].  Returns (routes (E, N), slots (E, N),
    counts (E,)) int32; compaction and the ``capacity`` clamp are per row.

    3D: ``conf`` (Q, E, N) with ``thresholds`` (Q, E, 2) — one row per
    (live query, edge) pair, each with its own thresholds and escalation
    buffer.  The query axis pads to ``bucket_q`` (pad rows conf -1.0,
    thresholds (1, 0)) and folds onto the 2D layout, so all live queries
    across all edges still cost one launch; outputs come back (Q, E, N) /
    (Q, E)."""
    conf = _f32(conf)
    thresholds = _f32(thresholds)
    if conf.ndim == 3:
        Q, E, n = conf.shape
        qb = _bk.bucket_q(Q)
        conf = _pad_rows(conf, qb - Q, -1.0)
        thresholds = _pad_rows(thresholds, qb - Q, PAD_THRESHOLDS)
        routes, slots, counts = triage_fleet(
            conf.reshape(qb * E, n), thresholds.reshape(qb * E, 2),
            capacity=capacity, device=device)
        return (routes.reshape(qb, E, n)[:Q], slots.reshape(qb, E, n)[:Q],
                counts.reshape(qb, E)[:Q])
    dev = resolve_device(device)
    E, n = conf.shape
    eb, nb = _bk.bucket(E), _bk.bucket(n)
    conf = F.pad(conf, (0, nb - n, 0, eb - E), value=-1.0)
    thresholds = _pad_rows(thresholds, eb - E, PAD_THRESHOLDS)
    routes, slots, counts = _tr.triage_fleet(
        conf.to(dev).contiguous(), thresholds.to(dev).contiguous(),
        capacity=capacity)
    return routes[:E, :n], slots[:E, :n], counts[:E]


def calibrate_fleet(scores, truths, *, iters: int = 8, min_count: int = 8,
                    device="cuda"):
    """Fleet-wide Platt recalibration: ONE fused launch per update event.

    ``scores`` (E, N) cloud-labeled edge confidences, right-padded with
    -1.0, and ``truths`` the matching (E, N) 0/1 cloud verdicts -> (params
    (E, 2) [a, b] of ``conf' = sigmoid(a*logit(conf)+b)``, counts (E,)
    valid labels per row).  Rows with fewer than ``min_count`` labels, or
    labels all one class, come back as the identity (1, 0).

    3D: (Q, E, N) inputs — the query axis pads to ``bucket_q`` with fully
    masked rows and folds onto the 2D layout, still one launch; ``params``
    comes back (Q, E, 2) and ``counts`` (Q, E)."""
    scores = _f32(scores)
    truths = _f32(truths)
    if scores.ndim == 3:
        Q, E, n = scores.shape
        qb = _bk.bucket_q(Q)
        scores = _pad_rows(scores, qb - Q, -1.0)
        truths = _pad_rows(truths, qb - Q, 0.0)
        params, counts = calibrate_fleet(
            scores.reshape(qb * E, n), truths.reshape(qb * E, n),
            iters=iters, min_count=min_count, device=device)
        return params.reshape(qb, E, 2)[:Q], counts.reshape(qb, E)[:Q]
    dev = resolve_device(device)
    E, n = scores.shape
    eb, nb = _bk.bucket(E), _bk.bucket(n)
    scores = F.pad(scores, (0, nb - n, 0, eb - E), value=-1.0)
    truths = F.pad(truths, (0, nb - n, 0, eb - E))
    params, counts = _ca.calibrate_fleet(
        scores.to(dev).contiguous(), truths.to(dev).contiguous(),
        iters=iters, min_count=min_count)
    return params[:E], counts[:E]


def _int32_on(x, dev: torch.device) -> torch.Tensor:
    """``x`` as a contiguous int32 tensor on ``dev``; a narrower input
    (uint8 frames) crosses to the device before it widens."""
    return torch.as_tensor(x).to(dev).to(torch.int32).contiguous()


def _frames_on(frames, dev: torch.device):
    """The three frames on ``dev`` as the fused cascade takes them: uint8
    or int32 frames of one dtype as they are, views with any camera stride
    included (no device operation); other or mixed dtypes widen to int32,
    and a camera block that is not contiguous is copied."""
    ts = [torch.as_tensor(f).to(dev) for f in frames]
    if len({t.dtype for t in ts}) > 1 or ts[0].dtype not in _pc.FRAME_DTYPES:
        ts = [t.to(torch.int32) for t in ts]
    return [t.contiguous() if t.ndim == 4 and t.shape[0] and
            not t[0].is_contiguous() else t for t in ts]


def framediff(f0, f1, f2, *, threshold: int = 40, maxval: int = 255,
              device="cuda") -> torch.Tensor:
    """Binary motion mask from 3 consecutive (B, H, W, 3) frames with
    values in [0, 255] -> (B, H, W) int32 in {0, maxval}."""
    dev = resolve_device(device)
    return _fd.framediff(*(_int32_on(f, dev) for f in (f0, f1, f2)),
                         threshold=threshold, maxval=maxval)


def dilate3x3(x, *, device="cuda") -> torch.Tensor:
    """(B, H, W) -> (B, H, W) int32 3x3 max, zero outside the image."""
    return _mo.dilate3x3(_int32_on(x, resolve_device(device)))


def erode3x3(x, maxval: int = 255, *, device="cuda") -> torch.Tensor:
    """(B, H, W) -> (B, H, W) int32 3x3 min, ``maxval`` outside."""
    return _mo.erode3x3(_int32_on(x, resolve_device(device)), maxval)


def pixel_cascade(f0, f1, f2, *, threshold: int = 40, maxval: int = 255,
                  fused: bool = True, device="cuda"):
    """Whole pixel frontend — framediff -> dilate -> erode -> count — in
    ONE device operation per tick.

    Frames are (B, H, W, 3) uint8/int with values in [0, 255]; returns
    ``(mask (B, H, W) int32, counts (B,) int32)`` where ``counts[b]`` is
    camera b's foreground pixel count, which ``detect`` uses to skip
    connected-component labelling for motionless cameras.  uint8 and
    int32 tensors already on ``device`` go to the kernel as they are,
    strided camera views included.

    ``fused=False`` runs the staged chain instead — three launches
    (framediff, dilate, erode) on int32 frames and a mask reduction — kept
    as the differential reference the fused kernel is held against."""
    dev = resolve_device(device)
    if fused:
        return _pc.pixel_cascade(*_frames_on((f0, f1, f2), dev),
                                 threshold=threshold, maxval=maxval)
    f0, f1, f2 = (_int32_on(f, dev) for f in (f0, f1, f2))
    mask = _mo.erode3x3(_mo.dilate3x3(_fd.framediff(
        f0, f1, f2, threshold=threshold, maxval=maxval)), maxval)
    return mask, (mask > 0).sum(dim=(1, 2), dtype=torch.int32)


def score_crops(score_fn, tokens, *, minimum: int = 8,
                device="cuda") -> torch.Tensor:
    """Bucket-padded per-tick crop scoring: ONE classifier launch per tick.

    ``tokens`` is the (N, T) patch-token matrix of every motion crop the
    whole camera fleet produced this scheduler tick and ``score_fn`` a
    ``(N, T) int64 tokens on device -> (N,) confidences`` model call.  N
    pads up to a power-of-two bucket (min 8) with rows of token 0 before
    the single call, then the pad is sliced back off; pad rows' scores
    never leave this function."""
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, dtype=torch.int64)
    n = tokens.shape[0]
    tokens = F.pad(tokens, (0, 0, 0, _bk.bucket(n, minimum) - n))
    return score_fn(tokens.to(dev))[:n]


def associate_tracks(emb, trk, crop_q, trk_q, thr, *, device="cuda"):
    """Fleet-wide re-ID association: ONE fused launch per scheduler tick.

    ``emb`` is the (M, D) matrix of every detection-crop embedding the
    whole fleet produced this tick (L2-normalized upstream: scores are
    cosines) and ``trk`` the (K, D) live track table across all track
    queries; ``crop_q`` (M,) / ``trk_q`` (K,) carry each row's query id (a
    crop only matches tracks of its own query) and ``thr`` (M,) each
    crop's acceptance floor.  Crops claim tracks greedily in row order,
    one-to-one.  Returns (assign (M,) int32, the matched row of the
    unpadded ``trk`` or -1; sim (M,) float32, the best unclaimed score the
    crop saw, -1e30 when its query had none).

    M, K and D pad to power-of-two buckets (min 8).  Pad crops carry query
    id -1 and threshold 2.0, pad tracks query id -2, so a pad row never
    matches or is claimed; pad crops come after the real ones, so the
    greedy order of the real crops is unchanged."""
    dev = resolve_device(device)
    emb, trk, thr = _f32(emb), _f32(trk), _f32(thr)
    crop_q = torch.as_tensor(crop_q, dtype=torch.int32)
    trk_q = torch.as_tensor(trk_q, dtype=torch.int32)
    M, D = emb.shape
    K = trk.shape[0]
    mb, kb, db = _bk.bucket(M), _bk.bucket(K), _bk.bucket(D)
    emb = F.pad(emb, (0, db - D, 0, mb - M))
    trk = F.pad(trk, (0, db - D, 0, kb - K))
    crop_q = F.pad(crop_q, (0, mb - M), value=-1)
    thr = F.pad(thr, (0, mb - M), value=2.0)
    trk_q = F.pad(trk_q, (0, kb - K), value=-2)
    assign, sim = _sim.associate(*(t.to(dev) for t in
                                   (emb, trk, crop_q, trk_q, thr)))
    return assign[:M], sim[:M]


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128, device="cuda") -> torch.Tensor:
    """Fused attention: q (B, H, Sq, hd), k/v (B, KV, Sk, hd) ->
    (B, H, Sq, hd), f32 or bf16, H % KV == 0, hd <= 256.

    ONE launch per call at the true Sq and Sk: no padding and no fallback
    (the reference pads to block multiples and falls back to its unfused
    oracle where padded keys would be visible).  ``block_q``/``block_k``
    are the reference's tile knobs, accepted for signature parity; they
    change nothing here."""
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(t).to(dev) for t in (q, k, v))
    return _fa.flash_attention(q, k, v, causal=causal)
