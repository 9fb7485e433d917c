"""Transformer layers: RMSNorm and LayerNorm, RoPE ('neox' and chatglm's
'2d'), QKV projection (with optional bias and per-head qk RMSNorm), GQA
attention with an optional logit softcap, the int8 KV-cache codec, the
SiLU-gated or GELU MLP and the sort-dispatched MoE — the reference's
``models/layers.py`` in PyTorch.

All functions are pure and shape-polymorphic; parameters are the nested
dicts of ``models/meta.py``.  The projections are plain ``torch.einsum``
(the reference leaves them to XLA, outside any Pallas kernel); where
their operands differ in dtype (bf16 activations against an f32 bias or
cache), they promote as ``jnp`` does.  Attention is the reference's
chunked path, except where the reference reaches its flash-attention
kernel (``attn_impl == "flash"``, a causal multi-token pass over its own
fresh K/V: every prefill); there it launches the port's kernel through
``kernels.ops.flash_attention``.  A setting the port does not know (a
``norm_type``, ``rope_style``, ``mlp_act`` or ``attn_impl`` outside the
reference's) raises ``NotImplementedError`` where it is read.
"""
from __future__ import annotations

import math
from time import perf_counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops as KOPS
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of an activation ``x`` and a weight ``w``, both
    promoted to one dtype, as ``jnp`` promotes mixed operands; on a
    device mesh (DTensor operands) a tensor-parallel product on each
    rank's shards (``sharding.local_einsum``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if SH.is_dtensor(x) or SH.is_dtensor(w):
        return SH.local_einsum(eq, x, w)
    return torch.einsum(eq, x, w)


def norm_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm (``cfg.norm_type``), computed in f32."""
    xf = x.to(torch.float32)
    if cfg.norm_type not in ("rmsnorm", "layernorm"):
        raise NotImplementedError(f"{cfg.name}: norm_type {cfg.norm_type!r}")
    if cfg.norm_type == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
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
    """cos/sin tables, shape (..., rot/2), where rot is the rotated width:
    head_dim under 'neox', half of it under '2d'.  positions: int (...,)."""
    rot = cfg.head_dim if cfg.rope_style == "neox" else cfg.head_dim // 2
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, rot, 2, dtype=torch.float32,
                     device=positions.device) / rot))
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(cfg: ModelConfig, x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B?, S, rot/2) broadcast over heads.

    'neox' rotates the full head_dim in the half-split layout; '2d'
    (chatglm) rotates the first half of head_dim as interleaved pairs and
    passes the second half through."""
    if cfg.rope_style == "none":
        return x
    if cfg.rope_style not in ("neox", "2d"):
        raise NotImplementedError(f"{cfg.name}: rope_style "
                                  f"{cfg.rope_style!r}")
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    if cfg.rope_style == "neox":
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        return torch.cat([r1, r2], dim=-1).to(x.dtype)
    rot = x.shape[-1] // 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    inter = torch.stack([r1, r2], dim=-1).reshape(r1.shape[:-1] + (rot,))
    return torch.cat([inter, xp.to(inter.dtype)], dim=-1).to(x.dtype)


def qkv_project(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, D) -> q (B, S, H, hd), k, v (B, S, KV, hd); plus the QKV
    biases under ``attn_bias`` and a per-head RMSNorm of q and k under
    ``qk_norm``."""
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.attn_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _no_merge(t: torch.Tensor, op: str) -> torch.Tensor:
    return t


def _scores_to_probs(scores: torch.Tensor, softcap: float,
                     merge=_no_merge) -> torch.Tensor:
    """Softmax over the last axis; ``merge`` reduces its max and its sum
    over the shards that hold the rest of the keys."""
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    m = merge(torch.amax(scores, dim=-1, keepdim=True), "max")
    e = torch.exp(scores - m)
    return e / merge(torch.sum(e, dim=-1, keepdim=True), "sum")


def attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              chunk: int = 512, merge=_no_merge) -> torch.Tensor:
    """GQA attention, f32 softmax.

    q (B, Sq, H, hd), k/v (B, Sk, KV, hd); q_pos (Sq,) or (B, Sq) and
    k_pos (Sk,) or (B, Sk) absolute positions (negative k_pos: an unwritten
    cache slot; per-row positions carry continuous-batching decode).  A
    key is seen when it is written, not after the query (``causal``) and,
    with a ``window``, fewer than ``window`` positions before it.  Returns
    (B, Sq, H, hd).

    Under ``cfg.attn_impl == "flash"``, a causal multi-token pass with no
    window over its own K/V (Sq == Sk, positions 0..S-1: a prefill) is one
    launch of the flash-attention kernel, exactly the reference's
    condition; like the reference's, that branch does not apply
    ``cfg.logit_softcap``.  DTensor q/k/v (on a device mesh) run on each
    shard's own rows and heads (``sharding.on_local_heads``): attention
    is head-local, so that is exact, and a flash launch takes the local
    heads.  A decode step over a cache whose sequence is split (the
    context-parallel layout) runs on each shard's own keys instead
    (``sharding.on_sequence_shards``): every shard takes the softmax's
    max, its sum of exponentials and the output over its keys, and
    ``merge`` all-reduces each of the three (a log-sum-exp merge, at the
    same rounding points), so the cache is never gathered.  Otherwise
    queries run in chunks of at most
    ``chunk`` (the largest divisor of Sq not above it, or one block where
    that is 1), so the score matrix is rarely Sq x Sk at once.  The
    chunked products accumulate in f32 for a multi-token pass; a decode
    step (Sq == 1) rounds the scores and the output to q's dtype, as the
    reference's products in q's dtype do, and caps the scores after
    masking, as the reference does."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    if cfg.attn_impl not in ("chunked", "flash"):
        raise NotImplementedError(f"{cfg.name}: attn_impl {cfg.attn_impl!r}")
    if SH.is_dtensor(q):
        if Sq == 1 and SH.split_dims(k, 1):
            return SH.on_sequence_shards(
                lambda q, k, v, qp, kp, merge: attention(
                    cfg, q, k, v, qp, kp, causal=causal, window=window,
                    merge=merge),
                q, k, v, q_pos, k_pos)
        return SH.on_local_heads(
            lambda q, k, v, qp, kp: attention(cfg, q, k, v, qp, kp,
                                              causal=causal, window=window,
                                              chunk=chunk),
            q, k, v, q_pos, k_pos)
    if (cfg.attn_impl == "flash" and Sq > 1 and causal and window is None
            and Sq == Sk):
        return _flash(q, k, v)
    if q_pos.ndim == 1:
        q_pos = q_pos[None].expand(B, Sq)
    if k_pos.ndim == 1:
        k_pos = k_pos[None].expand(B, Sk)
    acc = torch.float32 if Sq > 1 else q.dtype
    kf, vf = k.to(torch.float32), v.to(torch.float32)

    def block(qc: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
        c = qc.shape[1]
        qr = qc.reshape(B, c, KV, G, hd)
        s = torch.einsum("bckgh,bskh->bckgs", qr.to(torch.float32), kf)
        s = s.to(acc).to(torch.float32) * scale
        mask = k_pos[:, None, :] >= 0                      # (B, 1, Sk)
        if causal:
            mask = mask & (k_pos[:, None, :] <= qp[:, :, None])
        if window is not None:
            mask = mask & (k_pos[:, None, :] > qp[:, :, None] - window)
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        pr = _scores_to_probs(s, cfg.logit_softcap, merge).to(q.dtype)
        o = merge(torch.einsum("bckgs,bskh->bckgh", pr.to(torch.float32),
                               vf), "sum")
        return o.to(acc).reshape(B, c, H, hd).to(q.dtype)

    if Sq <= chunk:
        return block(q, q_pos)
    if Sq % chunk:
        chunk = max(d for d in range(1, chunk + 1) if Sq % d == 0)
        if chunk == 1:      # a prime Sq: one block, as the reference does
            return block(q, q_pos)
    return torch.cat([block(q[:, i:i + chunk], q_pos[:, i:i + chunk])
                      for i in range(0, Sq, chunk)], dim=1)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
    """One flash-attention launch on (B, S, H, hd) q and (B, S, KV, hd)
    k/v, causal, in the model's layout."""
    o = KOPS.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True, device=q.device)
    return o.transpose(1, 2)


def attn_out(p, o: torch.Tensor) -> torch.Tensor:
    return einsum("bshk,hkd->bsd", o, p["wo"])


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, KV, hd) -> (int8 values, (B, S, KV) f32 scales): symmetric
    per-token, per-KV-head quantization, rounding half to even."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None].to(torch.float32)
            ).to(dtype)


def _act(cfg: ModelConfig, h: torch.Tensor, g: Optional[torch.Tensor]
         ) -> torch.Tensor:
    """The MLP's nonlinearity: silu(g) * h, or (non-gated) GELU in its
    tanh approximation, ``jax.nn.gelu``'s default."""
    if cfg.mlp_act == "silu":
        return F.silu(g) * h
    if cfg.mlp_act == "gelu":
        return F.gelu(h, approximate="tanh")
    raise NotImplementedError(f"{cfg.name}: mlp_act {cfg.mlp_act!r}")


def mlp_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """SiLU-gated MLP (silu(x wg) * (x wi)) wo, or gelu(x wi) wo."""
    h = einsum("bsd,df->bsf", x, p["wi"])
    g = einsum("bsd,df->bsf", x, p["wg"]) if cfg.mlp_act == "silu" else None
    return einsum("bsf,fd->bsd", _act(cfg, h, g), p["wo"])


def moe_capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert for a row of ``S`` tokens:
    max(8, ceil(ceil(capacity_factor * S * top_k / E) / 8) * 8)."""
    cap = int(math.ceil(cfg.capacity_factor * S * cfg.top_k
                        / cfg.num_experts))
    return max(8, -(-cap // 8) * 8)


def _moe_route(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor):
    """Top-k routing of x (B, S, D) on an f32 softmax: (probs (B, S, E),
    the k weights renormalised over the k (B, S, K), their experts)."""
    logits = einsum("bsd,de->bse", x.to(torch.float32),
                    router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, cfg.top_k, dim=-1)      # (B, S, K)
    return probs, topw / torch.sum(topw, dim=-1, keepdim=True), topi


def _moe_dispatch(cfg: ModelConfig, x: torch.Tensor, topw: torch.Tensor,
                  topi: torch.Tensor):
    """Per-row sort-based dispatch with ``moe_capacity`` slots an expert:
    (slot -> token map (B, E*cap), slot weights (B, E*cap) f32, the
    expert buffers (B, E, cap, D) of x gathered at the slots).  A dropped
    choice and an empty slot hold the sentinel token S and weight 0."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    TK = S * K
    dev = x.device
    cap = moe_capacity(cfg, S)
    eflat, wflat = topi.reshape(B, TK), topw.reshape(B, TK)
    tflat = torch.arange(S, device=dev).repeat_interleave(K)[None].expand(
        B, TK)
    order = torch.argsort(eflat, dim=1, stable=True)
    es = torch.gather(eflat, 1, order)
    ws = torch.gather(wflat, 1, order)
    ts = torch.gather(tflat, 1, order)
    # position within the expert's group: index less its first occurrence
    first = torch.searchsorted(es, es, side="left")
    pos = torch.arange(TK, device=dev)[None] - first
    keep = pos < cap
    dest = torch.where(keep, es * cap + pos, E * cap)       # E*cap: a drop
    slot_token = torch.full((B, E * cap + 1), S, dtype=torch.long,
                            device=dev).scatter(1, dest, ts)[:, :-1]
    slot_w = torch.zeros((B, E * cap + 1), dtype=torch.float32,
                         device=dev).scatter(
        1, dest, torch.where(keep, ws, 0.0))[:, :-1]
    valid = (slot_token < S)[..., None]
    eb = torch.gather(x, 1, torch.clamp(slot_token, max=S - 1)[..., None]
                      .expand(B, E * cap, D))
    return slot_token, slot_w, torch.where(valid, eb, 0).reshape(
        B, E, cap, D)


def _moe_combine(ob: torch.Tensor, slot_token: torch.Tensor,
                 slot_w: torch.Tensor, S: int, first: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """The weighted scatter-add of the expert outputs ob (B, E', cap, D),
    experts ``first`` .. ``first + E' - 1``, back to their tokens: (B, S,
    D) in ``dtype`` (the sentinel token S lands in a spare row)."""
    B, El, cap, D = ob.shape
    cols = slice(first * cap, (first + El) * cap)
    st = slot_token[:, cols]
    contrib = (ob.reshape(B, El * cap, D) * slot_w[:, cols, None]).to(dtype)
    return torch.zeros((B, S + 1, D), dtype=dtype, device=ob.device
                       ).scatter_add(1, st[..., None].expand(B, El * cap, D),
                                     contrib)[:, :S]


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor, ctx=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), the Switch load-balance aux loss).

    Top-k routing on an f32 softmax (weights renormalised over the k),
    then per-row sort-based dispatch with ``moe_capacity`` slots an
    expert: each row's (token, choice) pairs are stably sorted by expert,
    the first ``cap`` of an expert keep their slot and the rest are
    dropped.  The slot -> token map and the slot weights are scattered
    into buffers with one spare slot (where the drops land, then cut
    off); the activations are gathered once at the slots, the experts run
    as one grouped product, and the combine is a weighted scatter-add
    from the slots (the sentinel token S lands in a spare row).  On the
    card that scatter-add's order is not fixed.  ``ctx`` constrains the
    (B, E, cap, D) expert buffers ("moe_buf") before and after the
    experts, where the reference does.

    On a device mesh (DTensor x) routing and dispatch run on each shard's
    own rows, whole (``sharding.on_local_rows``: a row's sort needs all
    its tokens), the experts on their "model" shards, and each shard's
    combine scatters its own experts' outputs, so the shards' partial
    sums are reduced (``sharding.reduce_partial``); the aux loss takes
    the means over every row.

    The call is the recorder's ``moe`` span; a decode step's (one token
    a row) counts the expert rows its grouped product runs
    (``moe.slots``: B*E*cap, the shape of the expert buffers) into the
    span open around it."""
    t0 = perf_counter()
    y, aux, rows = _moe_apply(cfg, p, x, ctx)
    tracing.leaf("moe", t0)
    if x.shape[1] == 1:
        tracing.count("moe.slots", rows)
    return y, aux


def _moe_apply(cfg: ModelConfig, p, x: torch.Tensor, ctx
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    c = ctx if ctx is not None else (lambda a, name: a)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    if SH.is_dtensor(x):
        probs, choices, slot_token, slot_w, eb = SH.on_local_rows(
            lambda xl, rl: _moe_local(cfg, xl, rl), 5, x, p["router"])
    else:
        probs, topw, topi = _moe_route(cfg, x, p["router"])
        choices = torch.sum(F.one_hot(topi, E).to(torch.float32), dim=2)
        slot_token, slot_w, eb = _moe_dispatch(cfg, x, topw, topi)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(choices, dim=(0, 1))
    aux = E * torch.sum(me * ce) / K

    eb = c(eb, "moe_buf")
    h = einsum("becd,edf->becf", eb, p["wi"])
    g = einsum("becd,edf->becf", eb, p["wg"]) if cfg.mlp_act == "silu" \
        else None
    ob = c(einsum("becf,efd->becd", _act(cfg, h, g), p["wo"]), "moe_buf")
    if SH.is_dtensor(ob):
        y = SH.reduce_partial(SH.on_expert_shards(
            lambda o, st, sw, first: _moe_combine(o, st, sw, S, first,
                                                  x.dtype),
            ob, slot_token, slot_w))
    else:
        y = _moe_combine(ob, slot_token, slot_w, S, 0, x.dtype)
    return y, aux.to(torch.float32), eb.shape[0] * eb.shape[1] * eb.shape[2]


def _moe_local(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor):
    """Routing and dispatch of one shard's rows: (probs, the choices an
    expert per token (B, S, E) f32, slot -> token map, slot weights,
    expert buffers)."""
    probs, topw, topi = _moe_route(cfg, x, router)
    choices = torch.sum(F.one_hot(topi, cfg.num_experts).to(torch.float32),
                        dim=2)
    return (probs, choices) + _moe_dispatch(cfg, x, topw, topi)
