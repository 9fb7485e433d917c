"""Fused re-ID similarity + greedy track association on the H100.

Cross-camera track queries match every detection crop's embedding
against the fleet-wide live track table once per scheduler tick, in one
launch: masked cosine scores ``emb @ trk.T`` (a crop only ever matches
tracks of its own query), then a greedy one-to-one assignment in crop
order, a crop taking its best unclaimed track when that score clears the
crop's own floor.

* ``associate`` is the wrapper: CUDA tensors launch the hand-written
  kernel ``csrc/associate.cu`` (one block, one thread per track and
  greedy step, f32 FMA dots, the claimed flags in shared memory) and bump
  ``LAUNCHES``; CPU tensors run ``associate_torch``.  There is no
  fallback between the two.
* ``associate_torch`` is the plain PyTorch version: the score matrix in
  one f32 matmul, then a Python loop over the crops.

Both replace ``repro.kernels.similarity.associate_pallas``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime

#: the score of a masked (other query's, or claimed) track: no threshold
#: in the wrapper's range can accept it
NEG_INF = -1e30
#: kernel launches made by ``associate`` (a CPU call never counts)
LAUNCHES = 0
#: the kernel keeps one claimed flag a track in the 48 KB of shared memory
#: a block gets without opting in: the largest bucketed K that fits
MAX_TRACKS = 1 << 15


def associate_torch(emb: torch.Tensor, trk: torch.Tensor,
                    crop_q: torch.Tensor, trk_q: torch.Tensor,
                    thr: torch.Tensor):
    """emb (M, D) f32, trk (K, D) f32, crop_q (M,) i32, trk_q (K,) i32,
    thr (M,) f32 -> (assign (M,) i32 track row or -1, sim (M,) f32 best
    unclaimed score, ``NEG_INF`` when the crop's query had none)."""
    M, K = emb.shape[0], trk.shape[0]
    assign = torch.full((M,), -1, dtype=torch.int32, device=emb.device)
    sim = torch.full((M,), NEG_INF, dtype=torch.float32, device=emb.device)
    if K == 0:
        return assign, sim
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=emb.device)
    s = torch.where(crop_q[:, None] == trk_q[None, :], emb @ trk.T, neg)
    claimed = torch.zeros(K, dtype=torch.bool, device=emb.device)
    for i in range(M):
        avail = torch.where(claimed, neg, s[i])
        j = int(torch.argmax(avail))   # the first maximum
        sim[i] = avail[j]
        if bool(avail[j] >= thr[i]):
            assign[i] = j
            claimed[j] = True
    return assign, sim


def _check(emb, trk, crop_q, trk_q, thr) -> None:
    for name, t, dt in (("emb", emb, torch.float32),
                        ("trk", trk, torch.float32),
                        ("crop_q", crop_q, torch.int32),
                        ("trk_q", trk_q, torch.int32),
                        ("thr", thr, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"associate takes {dt} {name}, got {t.dtype}")
    if emb.ndim != 2 or trk.ndim != 2 or emb.shape[1] != trk.shape[1]:
        raise ValueError(f"associate takes emb (M, D) and trk (K, D), got "
                         f"{tuple(emb.shape)} and {tuple(trk.shape)}")
    M, K = emb.shape[0], trk.shape[0]
    if crop_q.shape != (M,) or thr.shape != (M,) or trk_q.shape != (K,):
        raise ValueError(f"associate: crop_q {tuple(crop_q.shape)}, thr "
                         f"{tuple(thr.shape)}, trk_q {tuple(trk_q.shape)} "
                         f"do not match M={M}, K={K}")
    if len({t.device for t in (emb, trk, crop_q, trk_q, thr)}) != 1:
        raise ValueError("associate: inputs lie on different devices")


def associate(emb: torch.Tensor, trk: torch.Tensor, crop_q: torch.Tensor,
              trk_q: torch.Tensor, thr: torch.Tensor):
    """Greedy association on the tensors' device: the CUDA kernel for CUDA
    tensors, ``associate_torch`` for CPU tensors.  Shapes and outputs as
    ``associate_torch``."""
    global LAUNCHES
    _check(emb, trk, crop_q, trk_q, thr)
    if emb.device.type == "cpu":
        return associate_torch(emb, trk, crop_q, trk_q, thr)
    if emb.device.type != "cuda":
        raise ValueError(f"associate: no kernel for device {emb.device}")
    (M, D), K = emb.shape, trk.shape[0]
    if M == 0 or D == 0:
        raise ValueError(f"associate: empty emb {tuple(emb.shape)}")
    if K > MAX_TRACKS:
        raise ValueError(f"associate: at most {MAX_TRACKS} tracks a launch "
                         f"(one shared-memory flag each), got {K}")
    emb, trk, crop_q, trk_q, thr = (t.contiguous() for t in
                                    (emb, trk, crop_q, trk_q, thr))
    assign = torch.empty((M,), dtype=torch.int32, device=emb.device)
    sim = torch.empty((M,), dtype=torch.float32, device=emb.device)
    rc = runtime.library("associate").associate_launch(
        emb.data_ptr(), trk.data_ptr(), crop_q.data_ptr(), trk_q.data_ptr(),
        thr.data_ptr(), assign.data_ptr(), sim.data_ptr(), M, K, D,
        runtime.stream(emb.device))
    runtime.check_launch("associate", rc)
    LAUNCHES += 1
    return assign, sim
