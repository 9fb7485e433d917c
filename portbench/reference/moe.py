"""A mixture-of-experts decoder layer: pre-norm attention, then a
pre-norm sparse mixture of SiLU-gated experts of width ``d_ff``.

The router's logits go through an f32 softmax; the top ``top_k`` are
kept and their weights renormalised over the k; each expert takes at
most ``capacity(S)`` choices over the S tokens of one call, kept in
token order, the rest dropped (they add nothing).  The admission is one
call of the prompt's tokens; each decode step is a call of one token,
where the capacity of 8 slots an expert never drops a choice.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.model import (Precision, attend, attention_leaves,
                                       ffn, rms_norm)


def capacity(m: Dict, S: int) -> int:
    """Slots an expert over a call of ``S`` tokens."""
    cap = int(math.ceil(m["capacity_factor"] * S * m["top_k"]
                        / m["num_experts"]))
    return max(8, -(-cap // 8) * 8)


def layer_leaves(m: Dict) -> List[tuple]:
    """(path under ``layers``, shape, kind, fan-in) of a layer's leaves."""
    D, F_, L, E = m["d_model"], m["d_ff"], m["num_layers"], m["num_experts"]
    return attention_leaves(m) + [
        (("norm2", "scale"), (L, D), "norm", 0),
        (("moe", "router"), (L, D, E), "router", D),
        (("moe", "wi"), (L, E, D, F_), "wi", D),
        (("moe", "wg"), (L, E, D, F_), "wg", D),
        (("moe", "wo"), (L, E, F_, D), "wo", F_)]


def experts(m: Dict, p: Dict, i: int, h: torch.Tensor, capped: int,
            prec: Precision) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The experts of layer i over h (T, D): the first ``capped`` tokens
    are one call (capacity over them), every later token a call of its
    own.  Returns (y (T, D), each token's router margin: its k-th largest
    router logit less its (k+1)-th, the choices dropped)."""
    T, D = h.shape
    E, K = m["num_experts"], m["top_k"]
    logits = prec.mm(h, p["router"][i])
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, K, dim=-1)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)
    srt = torch.sort(logits, dim=-1, descending=True).values
    margin = srt[:, K - 1] - srt[:, K] if K < E else \
        torch.full((T,), float("inf"), device=h.device)
    chosen = F.one_hot(topi, E).sum(dim=1)                 # (T, E) 0/1
    rank = torch.cumsum(chosen[:capped], dim=0) - chosen[:capped]
    keep = torch.ones_like(chosen, dtype=torch.bool)
    keep[:capped] = rank < capacity(m, capped)
    dropped = int((chosen.bool() & ~keep).sum())
    weight = torch.zeros((T, E), dtype=h.dtype, device=h.device)
    weight.scatter_(1, topi, topw)
    weight = weight * (chosen.bool() & keep)
    y = torch.zeros_like(h)
    for e in range(E):
        rows = torch.nonzero(weight[:, e]).flatten()
        if rows.numel():
            out = ffn(h[rows], p["wi"][i, e], p["wg"][i, e], p["wo"][i, e],
                      prec)
            y.index_add_(0, rows, out * weight[rows, e, None])
    return y, margin, dropped


def block(m: Dict, lp: Dict, i: int, x: torch.Tensor, capped: int,
          prec: Precision) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Layer i over x (T, D): (x, each token's router margin, dropped)."""
    x = attend(m, lp, i, x, prec)
    h = rms_norm(x, lp["norm2"]["scale"][i], m["norm_eps"])
    y, margin, dropped = experts(m, lp["moe"], i, h, capped, prec)
    return x + y, margin, dropped
