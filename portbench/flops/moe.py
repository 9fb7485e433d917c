"""A mixture of experts: attention, then the router and ``top_k``
SiLU-gated experts of width d_ff a token (the choices, not the slots of
an expert's capacity)."""
from typing import Dict

from portbench.flops import attention_trunk, head


def prefill(m: Dict, S: int) -> float:
    """A batch-1 prefill of S tokens."""
    D = m["d_model"]
    moe = 2.0 * S * D * m["num_experts"] + \
        m["top_k"] * 3 * 2.0 * S * D * m["d_ff"]
    return attention_trunk(m, S, moe) + head(m)
