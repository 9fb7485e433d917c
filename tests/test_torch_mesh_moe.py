"""The MoE on a device mesh, on the CPU: reduced granite-moe-1b-a400m on
a ("data"=2, "model"=2) mesh of a 4-process ``gloo`` group
(``tests/torch_mesh_cases.py``), its 4 experts split over "model".

Routing and the sort-based dispatch run on each shard's own whole rows
(``sharding.on_local_rows``), the experts on their shards, and each
shard's combine scatters its own experts' outputs, reduced across the
shards.  Two train steps, one prefill and four decode steps must give
the one-process run's loss, grad_norm and aux loss within ``MESH_RTOL``
= 1e-5 (relative), its logits within ``LOGIT_ATOL`` = 1e-4, its greedy
tokens and its dropped expert choices at every dispatch call.  Under
both settings of the "moe_flat" constraint (``ActCtx``'s
``shard_moe_flat``; the reference constrains no tensor by that name, so
the two must agree); the second at a capacity factor of 0.5, so that
its train steps and prefill drop choices over capacity.
"""
import numpy as np
import pytest
import torch

import torch_mesh_cases as MC
from repro_torch.configs import get_config
from repro_torch.models import layers as L


@pytest.mark.parametrize("case", ["granite-moe-1b-a400m",
                                  "granite-moe-1b-a400m:no-moe-flat"])
def test_moe_mesh_matches_one_process(case):
    drops = MC.check(case, (2, 2))[4]
    assert len(drops) == 2 * 2 * 2 + 2 + 2 * MC.DECODE  # remat: 2 a layer
    # the tight capacity drops choices in training and in the prefill
    assert (drops.sum() > 0) == case.endswith("no-moe-flat")


def test_combine_over_expert_shards_sums_to_the_whole():
    """Each shard's combine scatters only its own experts' slots: the
    shards' partial results sum to the one-process combine."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    g = torch.Generator().manual_seed(4)
    B, S, D = 2, 16, cfg.d_model
    x = torch.randn(B, S, D, generator=g)
    router = torch.randn(D, cfg.num_experts, generator=g)
    _, topw, topi = L._moe_route(cfg, x, router)
    st, sw, eb = L._moe_dispatch(cfg, x, topw, topi)
    ob = eb * 1.5
    whole = L._moe_combine(ob, st, sw, S, 0, x.dtype)
    half = cfg.num_experts // 2
    parts = L._moe_combine(ob[:, :half], st, sw, S, 0, x.dtype) + \
        L._moe_combine(ob[:, half:], st, sw, S, half, x.dtype)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
