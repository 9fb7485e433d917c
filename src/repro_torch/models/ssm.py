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

from repro_torch.distributed import sharding as SH
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
    if SH.is_dtensor(x):
        return _ssm_block_mesh(
            cfg, p, z, xin, einsum("bsd,dgn->bsgn", x, p["wb"]),
            einsum("bsd,dgn->bsgn", x, p["wc"]),
            einsum("bsd,dh->bsh", x, p["wdt"]), conv_cache or {},
            ssd_state, decode)
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


def ssd_split(cfg: ModelConfig, tp: int) -> Optional[int]:
    """The dim of the SSD state (B, nh, hd, N) that a "model" axis of
    ``tp`` devices splits: the heads (1) where they divide it, else the
    head dim (2) where that divides it, else none (``sharding.
    cache_specs``' rule for the state cache).  The SSD is separable over
    both: heads share only B and C, and each (head, head-dim) channel
    carries its own state row."""
    if tp == 1:
        return None
    if cfg.ssm_heads % tp == 0 and cfg.ssm_heads > 1:
        return 1
    if cfg.ssm_headdim % tp == 0 and cfg.ssm_headdim > 1:
        return 2
    return None


def _ssm_block_mesh(cfg: ModelConfig, p, z, xin, bn, cn, dt_raw,
                    conv_cache, ssd_state, decode: bool):
    """``ssm_block`` past its in-projections on a device mesh: every step
    on local shards (``local_map``), so no view splits a sharded dim.

    The convs run per channel in their cache's layout (without a cache,
    in the SSD's); the SSD on the split of ``ssd_split``: local heads,
    or, where the heads do not divide the "model" axis, local head-dim
    channels of every head (the state cache's layout), or whole; so a
    decode step reads and writes only its own part of the state.  The
    gated RMSNorm sums its squares over the local channels and reduces
    them across the shards (heads split), or runs on the gathered y; the
    out-projection's partial sums are left to the residual's
    constraint.  In a backward pass, an input every shard holds whole but
    uses only part of (B and C, and all of them under a head-dim split)
    gets its gradient as partial sums."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = z.device_mesh
    B, S, d_in = z.shape
    nh, hd = cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    tp = SH.model_size(z)
    split = ssd_split(cfg, tp)
    coord = (mesh.get_coordinate()[mesh.mesh_dim_names.index("model")]
             if "model" in mesh.mesh_dim_names else 0)

    def act(dim):                       # an activation's placements
        return SH.tp_layout(z, dim)

    def weight(dim):
        return SH.tp_layout(None, dim, mesh)

    rows = SH.row_placements(z)

    def wgrad(pl):
        return SH.weight_grad(rows, pl)

    def partial_grad(pl):
        """Gradient placements: partial sums over the "model" dim for an
        input held whole there but used in part."""
        return [Partial() if split is not None and n == "model"
                and isinstance(q, Replicate) and mesh.size(i) > 1 else q
                for i, (n, q) in enumerate(zip(mesh.mesh_dim_names, pl))]

    def lm(fn, out, ins, *args, grads=None):
        return local_map(fn, out_placements=out, in_placements=ins,
                         in_grad_placements=grads, redistribute_inputs=True,
                         device_mesh=mesh)(*args)

    # the causal convs, each in its cache's channel layout
    heads_ch = 2 if split == 1 else None
    convs = {}
    for name, t, w in (("x", xin, p["conv_x"]),
                       ("b", bn, p["conv_b"]),
                       ("c", cn, p["conv_c"])):
        cache = conv_cache.get(name)
        if cache is not None:
            ch = 2 if SH.split_dims(cache, 2) else None
        else:
            ch = heads_ch if name == "x" else None
        if name != "x":                 # (B, S, G, N) -> (B, S, G*N)
            t = lm(lambda a: a.reshape(a.shape[0], a.shape[1], G * N),
                   act(None), (act(None),), t)
        ins = (act(ch), weight(None if ch is None else 1),
               None if cache is None else act(ch))
        convs[name] = lm(causal_conv, (act(ch), act(ch)), ins, t, w, cache,
                         grads=(ins[0], wgrad(ins[1]), ins[2]))

    # the SSD on the split's local part
    state_pl = act(split)
    if ssd_state is not None:
        ssd_state = SH.as_dtensor(ssd_state, mesh).redistribute(
            mesh, state_pl)
    nh_l = nh // tp if split == 1 else nh
    hd_l = hd // tp if split == 2 else hd
    h0 = coord * nh_l if split == 1 else 0      # the first local head
    d0 = coord * hd_l if split == 2 else 0      # the first head-dim channel

    def core(xl, bl, cl, dtl, dt_bias, a_log, d_skip, st):
        b, s = xl.shape[:2]
        xh = F.silu(xl).reshape(b, s, nh_l, hd)[..., d0:d0 + hd_l]
        Bm = F.silu(bl).reshape(b, s, G, N)
        Cm = F.silu(cl).reshape(b, s, G, N)
        if split == 1 and G > 1:        # each local head's group
            grp = (h0 + torch.arange(nh_l, device=xl.device)) // (nh // G)
            Bm, Cm = Bm[:, :, grp], Cm[:, :, grp]
        dt = F.softplus(dtl.to(f32) + dt_bias.to(f32))
        A = -torch.exp(a_log.to(f32))
        if decode:
            y1, st = ssd_decode_step(cfg, st, xh[:, 0], dt[:, 0], A,
                                     Bm[:, 0], Cm[:, 0], d_skip)
            return y1[:, None], st
        return ssd_chunked(cfg, xh, dt.to(xh.dtype), A, Bm, Cm, d_skip,
                           init_state=st)

    head = 0 if split == 1 else None
    ins = (act(heads_ch), act(None), act(None), act(2 if split == 1
                                                    else None),
           weight(head), weight(head), weight(head),
           None if ssd_state is None else state_pl)
    y4, state = lm(core, (act(None if split is None else split + 1),
                          state_pl), ins,
                   convs["x"][0], convs["b"][0], convs["c"][0], dt_raw,
                   p["dt_bias"], p["a_log"], p["d_skip"], ssd_state,
                   grads=tuple(None if q is None else partial_grad(
                       wgrad(q) if 4 <= i <= 6 else q)
                               for i, q in enumerate(ins)))

    # the gated RMSNorm over all d_inner channels, then the out-projection
    def gate(y, ss, zl, g):
        yf = y.reshape(zl.shape).to(f32)
        ms = ss / d_in
        return (yf * torch.rsqrt(ms + cfg.norm_eps) * g.to(f32)).to(
            y.dtype) * F.silu(zl)

    if split == 1:
        parts = [Partial() if n == "model" and mesh.size(i) > 1 else q
                 for i, (n, q) in enumerate(zip(mesh.mesh_dim_names,
                                                act(None)))]
        ss = SH.reduce_partial(lm(
            lambda y: torch.sum(torch.square(y.to(f32)), dim=(2, 3))[
                ..., None], parts, (act(2),), y4))
        ins = (act(2), act(None), act(2), weight(0))
        # each shard's gradient of the summed squares covers its channels
        yn = lm(gate, act(2), ins, y4, ss, z, p["gate_norm"],
                grads=(ins[0], partial_grad(ins[1]), ins[2], wgrad(ins[3])))
    else:
        ins = (act(None), act(None), weight(None))
        yn = lm(lambda y, zl, g: rms_norm(y.reshape(zl.shape), g,
                                          cfg.norm_eps) * F.silu(zl),
                act(None), ins, y4, z, p["gate_norm"],
                grads=ins[:2] + (wgrad(ins[2]),))
    out = einsum("bse,ed->bsd", yn, p["wo"])
    return out, ({k: v[1] for k, v in convs.items()}, state)
