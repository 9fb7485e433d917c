"""Fused GQA attention with an online softmax (flash attention) on the H100.

Every prefill of the cloud model under ``attn_impl="flash"`` runs its
causal self-attention through here, once a layer.

* ``flash_attention`` is the wrapper: CUDA tensors launch the
  hand-written kernel ``csrc/flash_attention.cu`` and bump ``LAUNCHES``;
  CPU tensors run ``flash_attention_torch``.  There is no fallback
  between the two, and nothing is padded.  At head dims 64 and 128
  (``TC_HEAD_DIMS``, every attention config of the repo) the kernel runs
  on the tensor cores with K and V brought in by TMA: f32 in split TF32
  (3xTF32, three TF32 products per f32 product), bf16 on bf16 products
  with P rounded to bf16.  Other head dims take its f32-FMA kernel.
  Either way a call is one launch.
* ``flash_attention_torch`` is the plain PyTorch version of the
  reference's unfused oracle ``ref.mha_ref``: f32 scores, a -1e30 causal
  mask, softmax, f32 product with V.

Both replace ``repro.kernels.flash_attention.flash_attention_pallas``.
Causal masking is top-left aligned (query i sees keys 0..i, also when
Sq != Sk), as in the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import runtime

NEG_INF = -1e30
#: kernel launches made by ``flash_attention`` (a CPU call never counts)
LAUNCHES = 0
#: the kernel keeps a thread's share of a (64, hd) f32 accumulator in
#: registers, hd padded to a multiple of 16: the largest head dim it takes
MAX_HEAD_DIM = 256
#: input dtypes the kernel takes, and the code ``flash_attention_launch``
#: knows each by
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims that run on the tensor cores (f32 and bf16); their K and V
#: come in by TMA, which wants 16-byte aligned bases and strides
TC_HEAD_DIMS = (64, 128)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q (B, H, Sq, hd), k/v (B, KV, Sk, hd) -> (B, H, Sq, hd) in q's
    dtype; query head h reads KV head h // (H // KV)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, Sq, hd).to(torch.float32)
    s = torch.einsum("bkgqh,bksh->bkgqs", qr, k.to(torch.float32))
    s = s / math.sqrt(hd)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.to(torch.float32))
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, H, Sq, hd) and k, v "
                         f"(B, KV, Sk, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head dim")
    if k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {k.shape[1]} KV heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} above "
                         f"{MAX_HEAD_DIM}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, "
                        f"v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("flash_attention: inputs lie on different devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention on the tensors' device: the CUDA kernel for CUDA tensors,
    ``flash_attention_torch`` for CPU tensors.  Shapes as
    ``flash_attention_torch``; any strides whose last axis is 1 (a
    transposed (B, S, H, hd) view goes in as it is), and the output keeps
    q's layout."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if B == 0 or Sq == 0 or Sk == 0 or hd == 0:
        raise ValueError(f"flash_attention: empty q {tuple(q.shape)} or k "
                         f"{tuple(k.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k and v must "
                         "be contiguous")
    o = torch.empty_like(q)     # q's layout (dense: contiguous otherwise)
    # an axis of extent 1 is never stepped along: its stride is moot
    strides = [st if n > 1 else 0 for t in (q, k, v, o)
               for n, st in zip(t.shape[:3], t.stride()[:3])]
    if hd in TC_HEAD_DIMS and (
            any(t.data_ptr() % 16 for t in (q, k, v))
            or any(st * q.element_size() % 16 for st in strides)):
        raise ValueError("flash_attention: at head dim 64 and 128 the "
                         "kernel needs q, k and v 16-byte aligned, with "
                         "strides of whole 16-byte units")
    rc = runtime.library("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KV, Sq,
        Sk, hd, int(bool(causal)), DTYPES[q.dtype], *strides,
        runtime.stream(q.device))
    runtime.check_launch("flash_attention", rc)
    LAUNCHES += 1
    return o
