"""The reference's ``remat_policy`` on the port, and the ``window`` the
dry-run's long-context decode needs, on the CPU.

* ``remat_policy`` "dots" and "dots_no_batch" give the loss and every
  gradient of plain ``remat`` (bit for bit on one thread) and the
  reference's under the same policy (``LOSS_ATOL``, ``GRAD_RTOL`` of
  ``tests/torch_train_cases.py``), on reduced qwen1.5-0.5b and
  granite-moe; the policies change what the backward recomputes: fewer
  matrix products than plain remat.
* ``make_prefill_step`` / ``make_decode_step`` with a ``window`` shorter
  than the cache: prefill and decode past the ring's end as the
  reference's do, logits within ``LOGIT_ATOL`` = 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.train import steps as RST
from repro_torch.models import meta as M
from repro_torch.train import steps as ST
from torch_model_cases import bridged, port_cfg
from torch_train_cases import (GRAD_FLOOR, GRAD_RTOL, LOSS_ATOL, Case,
                               one_torch_thread)  # noqa: F401

LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module", params=["qwen1.5-0.5b",
                                        "granite-moe-1b-a400m"])
def case(request):
    return Case(request.param)


def _grads(cfg, params, batch, policy):
    """(loss, {path: gradient}, ``bmm`` calls in the backward over a
    batch of 1 and over more)."""
    live = M.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = ST.make_loss_fn(cfg, remat=True, remat_policy=policy)(
        live, batch)
    counts = {"flat": 0, "batched": 0}

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default:
                counts["flat" if args[0].shape[0] == 1 else "batched"] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        loss.backward()
    return loss.detach(), {p: t.grad for p, t in M.leaves(live)
                           if t.grad is not None}, counts


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_remat_policy_matches_plain_remat_and_reference(case, policy):
    loss0, g0, n0 = _grads(case.cfg, case.tp, case.tbatch, None)
    loss, g, n = _grads(case.cfg, case.tp, case.tbatch, policy)
    assert float(loss) == float(loss0)
    assert set(g) == set(g0)
    for path in g0:
        torch.testing.assert_close(g[path], g0[path], rtol=0, atol=0)
    # what is saved changes: the projections' products (einsum's bmm over
    # a batch of 1) are not run again in the backward, and under "dots"
    # neither are attention's (and the experts')
    assert n["flat"] < n0["flat"]
    assert (n["batched"] < n0["batched"]) == (policy == "dots")
    (jl, _), jg = jax.value_and_grad(RST.make_loss_fn(
        case.ref_cfg, remat=True, remat_policy=policy), has_aux=True)(
            case.jp, case.jbatch)
    assert abs(float(loss) - float(jl)) <= LOSS_ATOL
    want = dict(M.leaves(jax.tree.map(np.asarray, jg)))
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        got = g[path].numpy() if path in g else np.zeros_like(w)
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        assert float(np.abs(got - w).max()) <= GRAD_RTOL * scale, path


def test_window_reaches_prefill_and_decode_steps():
    """An 8-token window on a 24-slot ring: a 16-token prefill and 12
    decode steps (the ring wraps), the port's step factories against the
    reference's.  The parent's factories take no ``window``."""
    ref_cfg = ref_get_config("qwen1.5-0.5b").reduced()
    cfg = port_cfg(ref_cfg)
    jp, tp = bridged(ref_cfg, jax.random.PRNGKey(4), 5)
    W, L, S, new = 8, 24, 16, 12
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, S + new)).astype(np.int32)
    jpre = RST.make_prefill_step(ref_cfg, cache_len=L, window=W)
    jdec = RST.make_decode_step(ref_cfg, window=W)
    tpre = ST.make_prefill_step(cfg, cache_len=L, window=W)
    tdec = ST.make_decode_step(cfg, window=W)
    jl, jc = jpre(jp, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tpre(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= LOGIT_ATOL
    for i in range(S, S + new):
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, i]))
        tl, tc = tdec(tp, tc, torch.from_numpy(toks[:, i]))
        gap = float(np.abs(tl.numpy() - np.asarray(jl)).max())
        assert gap <= LOGIT_ATOL, (i, gap)
    # the window is seen: the same cache decoded with no window differs
    tc2 = tpre(tp, {"tokens": torch.from_numpy(toks[:, :S])})[1]
    for i in range(S, S + new):
        free, tc2 = ST.make_decode_step(cfg)(tp, tc2,
                                             torch.from_numpy(toks[:, i]))
    assert float((free - tl).abs().max()) > LOGIT_ATOL
