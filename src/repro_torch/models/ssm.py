"""Mamba-2 (SSD: state-space duality) block, chunked — the reference's
``models/ssm.py`` in PyTorch.

The chunked SSD algorithm of arXiv:2405.21060: within a chunk the
quadratic ("attention-like") dual form runs as batched products; across
chunks a Python loop over the ``nc`` chunks carries the (heads, head_dim,
state) recurrent state (the reference's ``lax.scan``).  Decode is one
O(1) state update.  The reference writes no Pallas kernel here, so
neither does the port: every step is a plain PyTorch operation.

Shapes (per layer):
  x   (B, S, nh, hd)    inputs after in-proj + causal conv + SiLU
  dt  (B, S, nh)        softplus(dt_raw + dt_bias)
  A   (nh,)             negative reals, A = -exp(a_log)
  Bm  (B, S, G, N)      input matrix  (G groups, N = ssm_state)
  Cm  (B, S, G, N)      output matrix
State: (B, nh, hd, N), f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import einsum, rms_norm

f32 = torch.float32


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{k=j+1..i} a[..., k], -inf
    for j > i.  a (..., Q) log-decays -> (..., Q, Q)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(Q, device=a.device)
    return torch.where(ii[:, None] >= ii[None, :], diff, -torch.inf)


def ssd_chunked(cfg: ModelConfig, x: torch.Tensor, dt: torch.Tensor,
                A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                D_skip: torch.Tensor,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, nh, hd) in x's dtype, final state (B, nh, hd, N)).

    The chunk is ``min(cfg.ssm_chunk, S)``; an S that is not a multiple of
    it raises ``ValueError``, as the reference refuses it (padding would
    change the final state)."""
    B, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"{cfg.name}: sequence length {S} is not a multiple "
                         f"of the SSD chunk {Q} (ssm_chunk {cfg.ssm_chunk})")
    nc = S // Q
    rep = nh // G
    xf, dtf = x.to(f32), dt.to(f32)
    a = dtf * A.to(f32)[None, None, :]                   # (B, S, nh) <= 0
    xc = xf.reshape(B, nc, Q, nh, hd)
    dc = dtf.reshape(B, nc, Q, nh)
    ac = a.reshape(B, nc, Q, nh)
    Bh = Bm.to(f32).reshape(B, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Ch = Cm.to(f32).reshape(B, nc, Q, G, N).repeat_interleave(rep, dim=3)

    # intra-chunk (quadratic dual form): L[i, j] = exp(sum_{j<k<=i} a_k),
    # scores = (C_i . B_j) L_ij dt_j
    L = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))       # (B, nc, nh, Q, Q)
    cb = torch.einsum("bnqhs,bnkhs->bnhqk", Ch, Bh)
    W = cb * L * dc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bnhqk,bnkhd->bnqhd", W, xc)

    # chunk states: sum_j exp(sum_{k>j} a_k) dt_j B_j (x) x_j
    cum = torch.cumsum(ac, dim=2)                        # (B, nc, Q, nh)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    contrib = torch.einsum("bnqhs,bnqhd->bnhds",
                           Bh * (decay_to_end * dc)[..., None], xc)
    chunk_decay = torch.exp(torch.sum(ac, dim=2))        # (B, nc, nh)

    # inter-chunk recurrence over the nc chunks
    s = (torch.zeros((B, nh, hd, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    states_in = []
    for n in range(nc):
        states_in.append(s)
        s = s * chunk_decay[:, n, :, None, None] + contrib[:, n]
    states_in = torch.stack(states_in, dim=1)            # (B, nc, nh, hd, N)

    # inter-chunk output: y_i += C_i . (exp(cum_i) * state at chunk start)
    y_inter = torch.einsum("bnqhs,bnhds->bnqhd", Ch, states_in) * \
        torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, nh, hd)
    y = y + xf * D_skip.to(f32)[None, None, :, None]
    return y.to(x.dtype), s


def ssd_reference(cfg: ModelConfig, x: torch.Tensor, dt: torch.Tensor,
                  A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                  D_skip: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive per-step recurrence oracle: h' = h exp(dt A) + dt B (x) x,
    y = C . h' + D x."""
    B, S, nh, hd = x.shape
    N = Bm.shape[3]
    s = (torch.zeros((B, nh, hd, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    ys = []
    for t in range(S):
        y, s = ssd_decode_step(cfg, s, x[:, t], dt[:, t], A, Bm[:, t],
                               Cm[:, t], D_skip)
        ys.append(y)
    return torch.stack(ys, dim=1), s


def ssd_decode_step(cfg: ModelConfig, state: torch.Tensor, x: torch.Tensor,
                    dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, D_skip: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token update.  x (B, nh, hd), dt (B, nh), Bm/Cm (B, G, N),
    state (B, nh, hd, N) -> (y (B, nh, hd) in x's dtype, new f32 state)."""
    rep = x.shape[1] // Bm.shape[1]
    Bt = Bm.to(f32).repeat_interleave(rep, dim=1)        # (B, nh, N)
    Ct = Cm.to(f32).repeat_interleave(rep, dim=1)
    dtf, xf = dt.to(f32), x.to(f32)
    dec = torch.exp(dtf * A.to(f32)[None, :])
    state = state.to(f32) * dec[:, :, None, None] + \
        (dtf[:, :, None, None] * xf[..., None]) * Bt[:, :, None, :]
    y = torch.einsum("bhn,bhdn->bhd", Ct, state)
    y = y + xf * D_skip.to(f32)[None, :, None]
    return y.to(x.dtype), state


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x (B, S, C), w (W, C), cache (B, W-1, C)
    of the previous context (zeros if None) -> (y (B, S, C) in x's dtype,
    the new cache: the last W-1 inputs, the old cache's included)."""
    B, S, C = x.shape
    W = w.shape[0]
    if cache is None:
        cache = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([cache, x], dim=1)                    # (B, S+W-1, C)
    y = torch.zeros((B, S, C), dtype=f32, device=x.device)
    for i in range(W):                                   # W <= 4 shifts
        y = y + xp[:, i:i + S].to(f32) * w[i].to(f32)
    return y.to(x.dtype), xp[:, S:]


def ssm_block(cfg: ModelConfig, p, x: torch.Tensor, conv_cache=None,
              ssd_state: Optional[torch.Tensor] = None, decode: bool = False):
    """The Mamba-2 mixer: in-projections -> causal convs -> SiLU -> SSD ->
    gated RMSNorm -> out-projection.

    x (B, S, D); conv_cache ``{"x", "b", "c"}`` each (B, W-1, *) or None;
    ssd_state (B, nh, hd, N) or None.  With ``decode`` x is one token
    (S = 1) and the state advances one step.  Returns (y (B, S, D),
    (new conv cache, new state))."""
    B, S, D = x.shape
    nh, hd = cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    z = einsum("bsd,de->bse", x, p["wz"])
    xin = einsum("bsd,de->bse", x, p["wx"])
    bin_ = einsum("bsd,dgn->bsgn", x, p["wb"]).reshape(B, S, G * N)
    cin = einsum("bsd,dgn->bsgn", x, p["wc"]).reshape(B, S, G * N)
    dt_raw = einsum("bsd,dh->bsh", x, p["wdt"])

    cc = conv_cache or {}
    xc, ncx = causal_conv(xin, p["conv_x"], cc.get("x"))
    bc, ncb = causal_conv(bin_, p["conv_b"], cc.get("b"))
    ccv, ncc = causal_conv(cin, p["conv_c"], cc.get("c"))
    xh = F.silu(xc).reshape(B, S, nh, hd)
    Bm = F.silu(bc).reshape(B, S, G, N)
    Cm = F.silu(ccv).reshape(B, S, G, N)
    # F.softplus returns x above 20 where jax.nn.softplus returns
    # log(1 + exp(x)); in f32 the two round to the same value there
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["a_log"].to(f32))
    if decode:
        y1, state = ssd_decode_step(cfg, ssd_state, xh[:, 0], dt[:, 0], A,
                                    Bm[:, 0], Cm[:, 0], p["d_skip"])
        y = y1[:, None]
    else:
        y, state = ssd_chunked(cfg, xh, dt.to(xh.dtype), A, Bm, Cm,
                               p["d_skip"], init_state=ssd_state)
    y = y.reshape(B, S, cfg.ssm_d_inner)
    yn = rms_norm(y, p["gate_norm"], cfg.norm_eps) * F.silu(z)
    out = einsum("bse,ed->bsd", yn, p["wo"])
    return out, ({"x": ncx, "b": ncb, "c": ncc}, state)
