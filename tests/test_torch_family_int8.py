"""int8 weights for the new families: the reduced granite-moe (its experts
and router) and hymba (its SSM projections and convs beside attention)
quantized per output channel, against the bf16 model and the reference.

Tolerances: the reference test's 6% of the bf16 model's logits
(``tests/test_quantize.py::test_int8_weights_forward_close``), and 1e-2 of
the reference's int8-weight logits (as ``tests/test_torch_quantize.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed import quantize as JQ
from repro.models import transformer as JT
from repro_torch.distributed import quantize as QZ
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from torch_model_cases import as_long, bridged, port_cfg, tokens

INT8_REL = 0.06
INT8_WEIGHT_RTOL = 1e-2


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "hymba-1.5b"])
def test_int8_weights_forward_close(arch):
    """bf16 weights quantized to int8 (experts and SSM projections too)
    compute in bf16: logits within 6% of the bf16 model's, and within
    1e-2 of the reference's int8-weight logits."""
    ref_cfg = ref_get_config(arch).reduced()
    jp, tp = bridged(ref_cfg, jax.random.PRNGKey(0), 7)
    cfg = port_cfg(ref_cfg)
    toks = tokens(8, (2, 24), cfg.vocab_size)
    jq = JQ.quantize_tree(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
                          ref_cfg)
    h, _ = JT.forward(ref_cfg, jq, jnp.asarray(toks))
    ref_int8 = np.asarray(JT.lm_logits(ref_cfg, jq, h).astype(jnp.float32))
    params = M.tree_map(lambda t: t.to(torch.bfloat16), tp)
    qp = QZ.quantize_tree(params, cfg)
    block = "moe" if cfg.is_moe else "ssm"
    assert qp["layers"][block]["wi" if cfg.is_moe else "wx"]["q"].dtype == \
        torch.int8
    want = T.lm_logits(cfg, params, T.forward(cfg, params,
                                              as_long(toks))[0]).float()
    hq, _ = T.forward(cfg, qp, as_long(toks))
    assert hq.dtype == torch.bfloat16
    got = T.lm_logits(cfg, qp, hq).float()
    rel = float((want - got).abs().max() / want.abs().max())
    assert rel < INT8_REL, rel
    gap = np.abs(got.numpy() - ref_int8).max() / np.abs(ref_int8).max()
    assert gap < INT8_WEIGHT_RTOL, gap
