"""The model FLOPs a served request needs, from its shapes, by family.

Each family's count is a file of its own, ``flops/<family>.py`` with a
``prefill(m, S)``, found by a configuration's ``family``: a later family
is a new file.  A product of (m, k) by (k, n) is 2mkn operations.  A
mixture of experts counts its ``top_k`` choices a token, never the empty
or padded slots of an expert's capacity; causal attention counts each
query against the keys at or before it.  The embedding lookup, norms,
softmax and biases are left out (under 1% here).  The prefill's head runs
on its last position only, as the served program needs.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Optional


def attention_trunk(m: Dict, S: int, mixer: float) -> float:
    """``num_layers`` layers of grouped-query causal attention over S
    tokens, each followed by a mixer of ``mixer`` operations."""
    D, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    proj = 2.0 * S * D * (H + 2 * KV) * hd + 2.0 * S * H * hd * D
    attn = 4.0 * H * hd * S * (S + 1) / 2
    return m["num_layers"] * (proj + attn + mixer)


def head(m: Dict) -> float:
    """The head over the last position."""
    return 2.0 * m["d_model"] * m["vocab_size"]


def prefill_of(family: str) -> Optional[Callable[[Dict, int], float]]:
    """The batch-1 prefill count of ``family`` (``flops/<family>.py``),
    or None where the family has no file."""
    try:
        mod = importlib.import_module(f"portbench.flops.{family}")
    except ModuleNotFoundError as e:
        if e.name != f"portbench.flops.{family}":
            raise
        return None
    return mod.prefill
