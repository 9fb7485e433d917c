"""Serving the new families: the port's ``DecodeEngine`` and
``CascadeServer`` on the reduced granite-moe (MoE), hymba (hybrid) and
mamba2 (SSM) against the reference's engine on bridged weights
(``tests/test_torch_family_int8.py`` serves two of them in int8).

The engines must give the same routes, the same greedy tokens and, at the
end, the same engine cache (K/V, conv windows and SSD state within 1e-4:
f32, the same operations in another order).  The reduced models' greedy
tokens hardly depend on the context at the init scale, so the cache is
what shows each slot's prefill and decode were the reference's.  Prompts
are at most one SSD chunk long (32 tokens in the reduced configs), as the
reference's ``ssd_chunked`` requires.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.thresholds import ThresholdState as RefThresholdState
from repro.serving.engine import CascadeServer as RefCascadeServer
from repro.serving.engine import DecodeEngine as RefDecodeEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.core.thresholds import ThresholdState
from repro_torch.models import meta as M
from repro_torch.serving.engine import CascadeServer, DecodeEngine, Request
from torch_model_cases import bridged, port_cfg, tokens

SERVED = ["granite-moe-1b-a400m", "hymba-1.5b", "mamba2-2.7b"]
CACHE_ATOL = 1e-4


def _np_leaves(layers):
    """Engine cache leaves by path, as numpy, from either package."""
    if isinstance(jax.tree.leaves(layers)[0], torch.Tensor):
        return {p: t.numpy() for p, t in M.leaves(layers)}
    return dict(M.leaves(jax.tree.map(np.asarray, layers)))


@pytest.mark.parametrize("arch", SERVED)
def test_decode_engine_matches_reference(arch):
    """Four prompts through three slots (the fourth waits for a freed
    slot): the same tokens, and the same engine cache at the end."""
    ref_cfg = ref_get_config(arch).reduced()
    jp, tp = bridged(ref_cfg, jax.random.PRNGKey(11), 4)
    cfg = port_cfg(ref_cfg)
    prompts = [tokens(50 + i, (n,), cfg.vocab_size)
               for i, n in enumerate((12, 32, 20, 12))]

    def drive(engine, request):
        queue = [request(rid=i, tokens=p, max_new=4 + i)
                 for i, p in enumerate(prompts)]
        outs = {}
        while queue or engine.active:
            while queue and engine.admit(queue[0]):
                queue.pop(0)
            for rid, gen in engine.step():
                outs[rid] = [int(t) for t in gen]
        return outs, _np_leaves(engine.cache["layers"])

    got, got_cache = drive(DecodeEngine(cfg, tp, slots=3, cache_len=40,
                                        device="cpu"), Request)
    want, want_cache = drive(RefDecodeEngine(ref_cfg, jp, slots=3,
                                             cache_len=40), RefRequest)
    assert got == want and sorted(got) == [0, 1, 2, 3]
    assert [len(got[i]) for i in range(4)] == [4, 5, 6, 7]
    assert sorted(got_cache) == sorted(want_cache)
    for name, leaf in want_cache.items():
        np.testing.assert_allclose(got_cache[name], leaf, atol=CACHE_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("arch", SERVED)
def test_cascade_server_matches_reference(arch):
    """The edge variant triages eight prompts, the cloud (under flash, the
    reference's kernel in interpret mode) decodes the uncertain ones:
    the same routes, tokens and waits as the reference's server."""
    ref_cloud_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                        attn_impl="flash")
    ref_edge_cfg = ref_get_config(arch).edge_variant()
    j_cloud, t_cloud = bridged(ref_cloud_cfg, jax.random.PRNGKey(12), 5)
    j_edge, t_edge = bridged(ref_edge_cfg, jax.random.PRNGKey(13), 6)
    cloud_cfg, edge_cfg = port_cfg(ref_cloud_cfg), port_cfg(ref_edge_cfg)
    lengths = (8, 16, 8, 32, 16, 8, 32, 16)
    prompts = [tokens(60 + i, (n,), edge_cfg.vocab_size)
               for i, n in enumerate(lengths)]

    def port_server(th):
        return CascadeServer(edge_cfg, t_edge, cloud_cfg, t_cloud, slots=3,
                             cache_len=40, thresholds=th, device="cpu")

    conf = sorted(port_server(None).edge_conf(p) for p in prompts)
    assert min(b - a for a, b in zip(conf, conf[1:])) > 1e-5
    alpha, beta = (conf[-2] + conf[-1]) / 2, (conf[0] + conf[1]) / 2
    got = port_server(ThresholdState(alpha=alpha, beta=beta)).run(
        [Request(rid=i, tokens=p, max_new=5) for i, p in enumerate(prompts)])
    want = RefCascadeServer(
        ref_edge_cfg, j_edge, ref_cloud_cfg, j_cloud, slots=3, cache_len=40,
        thresholds=RefThresholdState(alpha=alpha, beta=beta)).run(
        [RefRequest(rid=i, tokens=p, max_new=5)
         for i, p in enumerate(prompts)])
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    routes = [got[i].route for i in range(len(prompts))]
    assert routes.count("cloud") == 6
    for i in range(len(prompts)):
        assert got[i].route == want[i].route
        np.testing.assert_array_equal(got[i].output,
                                      np.asarray(want[i].output))
        assert got[i].ticks_waited == want[i].ticks_waited
