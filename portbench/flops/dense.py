"""A dense decoder: attention, then a SiLU-gated MLP of width d_ff."""
from typing import Dict

from portbench.flops import attention_trunk, head


def prefill(m: Dict, S: int) -> float:
    """A batch-1 prefill of S tokens."""
    mlp = 3 * 2.0 * S * m["d_model"] * m["d_ff"]
    return attention_trunk(m, S, mlp) + head(m)
