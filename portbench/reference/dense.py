"""A dense decoder layer: pre-norm attention, then a pre-norm SiLU-gated
MLP of width ``d_ff``."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference.model import (Precision, attend, attention_leaves,
                                       ffn, rms_norm)


def layer_leaves(m: Dict) -> List[tuple]:
    """(path under ``layers``, shape, kind, fan-in) of a layer's leaves."""
    D, F, L = m["d_model"], m["d_ff"], m["num_layers"]
    return attention_leaves(m) + [
        (("norm2", "scale"), (L, D), "norm", 0),
        (("mlp", "wi"), (L, D, F), "wi", D),
        (("mlp", "wg"), (L, D, F), "wg", D),
        (("mlp", "wo"), (L, F, D), "wo", F)]


def block(m: Dict, lp: Dict, i: int, x: torch.Tensor, capped: int,
          prec: Precision) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Layer i over x (T, D): (x, +inf router margins, 0 dropped)."""
    x = attend(m, lp, i, x, prec)
    h = rms_norm(x, lp["norm2"]["scale"][i], m["norm_eps"])
    mp = lp["mlp"]
    x = x + ffn(h, mp["wi"][i], mp["wg"][i], mp["wo"][i], prec)
    return x, torch.full((x.shape[0],), float("inf"), device=x.device), 0
