"""Fused fleet-wide confidence recalibration (Platt) on the H100.

The compute heart of the cloud->edge learning loop: every cloud
re-classification is an exact label for the edge confidence that
escalated, and every ``update_period_s`` the feedback stage fits, for
every (query, edge) row at once, a two-parameter Platt map

    conf' = sigmoid(a * logit(conf) + b)

by masked Newton-Raphson on each row's smoothed logistic negative
log-likelihood — ONE (R, N) launch per update event.  Rows are
independent; the 2x2 Newton system is solved in closed form per row
(ridge-damped by ``PRIOR`` so fully-masked rows stay finite), and
degenerate rows (too few labels, or labels all one class) come back as the
identity (1, 0).  Pad lanes carry score -1.0 and are masked out of every
sum; pad rows are fully masked and fit to the identity.

* ``calibrate_fleet`` is the wrapper: a CUDA tensor launches the
  hand-written kernel ``csrc/calibrate.cu`` (one 128-thread block per row)
  and bumps ``LAUNCHES``; a CPU tensor runs ``calibrate_fleet_torch``.
  There is no fallback between the two.
* ``calibrate_fleet_torch`` is the plain PyTorch version: vectorised f32
  Newton in the same operation order as the reference's ``_fit_rows``.

Both replace ``repro.kernels.calibrate.calibrate_fleet_pallas``; the
constants below are the reference's, unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime

# Score clipping before the logit transform.  apply_calibration on the
# numpy side MUST use the same epsilon so train-time and serve-time
# features agree.
EPS = 1e-4
PRIOR = 0.5           # MAP pull of (a, b) toward the identity (1, 0): a
#                       dozen-label fit stays near identity, hundreds of
#                       labels override it — bad small-sample maps are the
#                       loop's main failure mode
A_MIN, A_MAX = 0.05, 6.0
B_MAX = 8.0

#: widest row the kernel takes: x, target and mask of every lane stay in
#: shared memory (12 bytes a lane, inside the 48 KB a block gets by default)
MAX_LANES = 2048

#: kernel launches made by ``calibrate_fleet`` (a CPU call never counts)
LAUNCHES = 0


def calibrate_fleet_torch(scores: torch.Tensor, truths: torch.Tensor, *,
                          iters: int, min_count: int):
    """scores (R, N) f32 (pad lanes -1.0), truths (R, N) f32 {0, 1} ->
    (params (R, 2) f32 [a, b], counts (R,) i32 valid labels per row)."""
    mask = (scores >= 0.0).to(torch.float32)
    c = torch.clamp(scores, EPS, 1.0 - EPS)
    x = torch.log(c / (1.0 - c))                        # logit feature
    y01 = truths.to(torch.float32)
    n = torch.sum(mask, dim=1)
    pos = torch.sum(mask * y01, dim=1)
    neg = n - pos
    # Platt target smoothing: regress on (N+ + 1)/(N+ + 2) and 1/(N- + 2)
    # instead of hard 0/1, so a by-chance-separable buffer cannot drive the
    # fit to a step function
    t_pos = ((pos + 1.0) / (pos + 2.0))[:, None]
    t_neg = (1.0 / (neg + 2.0))[:, None]
    y = torch.where(y01 > 0.5, t_pos, t_neg)
    rows = scores.shape[0]
    a = torch.ones((rows,), dtype=torch.float32, device=scores.device)
    b = torch.zeros((rows,), dtype=torch.float32, device=scores.device)
    for _ in range(iters):
        p = torch.sigmoid(a[:, None] * x + b[:, None])
        resid = mask * (p - y)
        g0 = torch.sum(resid * x, dim=1) + PRIOR * (a - 1.0)
        g1 = torch.sum(resid, dim=1) + PRIOR * b
        w = mask * p * (1.0 - p)
        h00 = torch.sum(w * x * x, dim=1) + PRIOR
        h01 = torch.sum(w * x, dim=1)
        h11 = torch.sum(w, dim=1) + PRIOR
        det = h00 * h11 - h01 * h01
        da = (h11 * g0 - h01 * g1) / det
        db = (h00 * g1 - h01 * g0) / det
        a = torch.clamp(a - da, A_MIN, A_MAX)
        b = torch.clamp(b - db, -B_MAX, B_MAX)
    # degenerate rows keep the identity map: too few cloud labels, or the
    # labels are single-class (a separable 1D logistic diverges)
    ok = (n >= min_count) & (pos >= 1.0) & (pos <= n - 1.0)
    params = torch.stack([torch.where(ok, a, 1.0), torch.where(ok, b, 0.0)],
                         dim=1)
    return params, n.to(torch.int32)


def _check(scores: torch.Tensor, truths: torch.Tensor) -> None:
    if scores.dtype != torch.float32 or truths.dtype != torch.float32:
        raise TypeError(f"calibrate_fleet takes float32 scores/truths, got "
                        f"{scores.dtype}/{truths.dtype}")
    if scores.ndim != 2 or truths.shape != scores.shape:
        raise ValueError(f"calibrate_fleet takes scores and truths of one "
                         f"(R, N) shape, got {tuple(scores.shape)} and "
                         f"{tuple(truths.shape)}")
    if scores.device != truths.device:
        raise ValueError(f"scores on {scores.device} but truths on "
                         f"{truths.device}")


def calibrate_fleet(scores: torch.Tensor, truths: torch.Tensor, *,
                    iters: int, min_count: int):
    """Fleet Platt fit on the tensors' device: the CUDA kernel for CUDA
    tensors, ``calibrate_fleet_torch`` for CPU tensors.

    scores (R, N) f32 (pad lanes -1.0), truths (R, N) f32 {0, 1} ->
    (params (R, 2) f32 [a, b], counts (R,) i32 valid labels per row)."""
    global LAUNCHES
    _check(scores, truths)
    if scores.device.type == "cpu":
        return calibrate_fleet_torch(scores, truths, iters=iters,
                                     min_count=min_count)
    if scores.device.type != "cuda":
        raise ValueError(
            f"calibrate_fleet: no kernel for device {scores.device}")
    rows, n = scores.shape
    if rows == 0 or not 0 < n <= MAX_LANES:
        raise ValueError(f"calibrate_fleet: kernel takes 1..{MAX_LANES} "
                         f"lanes per row and >= 1 row, got "
                         f"{tuple(scores.shape)}")
    if not (scores.is_contiguous() and truths.is_contiguous()):
        raise ValueError("calibrate_fleet: scores and truths must be "
                         "contiguous")
    params = torch.empty((rows, 2), dtype=torch.float32, device=scores.device)
    counts = torch.empty((rows,), dtype=torch.int32, device=scores.device)
    lib = runtime.library("calibrate")
    rc = lib.calibrate_launch(
        scores.data_ptr(), truths.data_ptr(), params.data_ptr(),
        counts.data_ptr(), rows, n, int(iters), int(min_count),
        runtime.stream(scores.device))
    runtime.check_launch("calibrate", rc)
    LAUNCHES += 1
    return params, counts
