"""Transformer layers of the dense models: RMSNorm, RoPE, QKV projection
(with optional bias and per-head qk RMSNorm), GQA attention, SiLU-gated
MLP — the dense subset of the reference's ``models/layers.py``, in
PyTorch.

All functions are pure and shape-polymorphic; parameters are the nested
dicts of ``models/meta.py``.  The projections are plain ``torch.einsum``
(the reference leaves them to XLA, outside any Pallas kernel).  Attention
is the reference's chunked path, except where the reference reaches its
flash-attention kernel (``attn_impl == "flash"``, a causal multi-token
pass over its own fresh K/V: every prefill); there it launches the port's
kernel through ``kernels.ops.flash_attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KOPS
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def norm_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm, computed in f32."""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis with a given scale, computed in f32."""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


def rope_freqs(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin tables, shape (..., head_dim/2).  positions: int (...,)."""
    rot = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, rot, 2, dtype=torch.float32,
                     device=positions.device) / rot))
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(cfg: ModelConfig, x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """'neox' RoPE: x (B, S, H, hd) rotated over the full head_dim in the
    half-split layout; cos/sin (B?, S, hd/2) broadcast over heads."""
    if cfg.rope_style == "none":
        return x
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1, r2], dim=-1).to(x.dtype)


def qkv_project(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, D) -> q (B, S, H, hd), k, v (B, S, KV, hd); plus the QKV
    biases under ``attn_bias`` and a per-head RMSNorm of q and k under
    ``qk_norm``."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.attn_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              chunk: int = 512) -> torch.Tensor:
    """GQA attention, f32 scores and softmax.

    q (B, Sq, H, hd), k/v (B, Sk, KV, hd); q_pos (Sq,) or (B, Sq) and
    k_pos (Sk,) or (B, Sk) absolute positions (negative k_pos: an unwritten
    cache slot; per-row positions carry continuous-batching decode).  A
    key is seen when it is written, not after the query (``causal``) and,
    with a ``window``, fewer than ``window`` positions before it.  Returns
    (B, Sq, H, hd).

    Under ``cfg.attn_impl == "flash"``, a causal multi-token pass with no
    window over its own K/V (Sq == Sk, positions 0..S-1: a prefill) is one
    launch of the flash-attention kernel, exactly the reference's
    condition.  Otherwise queries run in chunks of at most ``chunk`` (the
    largest divisor of Sq not above it, or one block where that is 1), so
    the score matrix is rarely Sq x Sk at once."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    if (cfg.attn_impl == "flash" and Sq > 1 and causal and window is None
            and Sq == Sk):
        o = KOPS.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 device=q.device)
        return o.transpose(1, 2)
    if q_pos.ndim == 1:
        q_pos = q_pos[None].expand(B, Sq)
    if k_pos.ndim == 1:
        k_pos = k_pos[None].expand(B, Sk)

    def block(qc: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
        c = qc.shape[1]
        qr = qc.reshape(B, c, KV, G, hd)
        s = torch.einsum("bckgh,bskh->bckgs", qr.to(torch.float32),
                         k.to(torch.float32)) * scale
        mask = k_pos[:, None, :] >= 0                      # (B, 1, Sk)
        if causal:
            mask = mask & (k_pos[:, None, :] <= qp[:, :, None])
        if window is not None:
            mask = mask & (k_pos[:, None, :] > qp[:, :, None] - window)
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)
        e = torch.exp(s - m)
        pr = (e / torch.sum(e, dim=-1, keepdim=True)).to(q.dtype)
        o = torch.einsum("bckgs,bskh->bckgh", pr.to(torch.float32),
                         v.to(torch.float32))
        return o.reshape(B, c, H, hd).to(q.dtype)

    if Sq <= chunk:
        return block(q, q_pos)
    if Sq % chunk:
        chunk = max(d for d in range(1, chunk + 1) if Sq % d == 0)
        if chunk == 1:      # a prime Sq: one block, as the reference does
            return block(q, q_pos)
    return torch.cat([block(q[:, i:i + chunk], q_pos[:, i:i + chunk])
                      for i in range(0, Sq, chunk)], dim=1)


def attn_out(p, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def mlp_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """SiLU-gated MLP: (silu(x wg) * (x wi)) wo."""
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    g = torch.einsum("bsd,df->bsf", x, p["wg"])
    return torch.einsum("bsf,fd->bsd", F.silu(g) * h, p["wo"])
