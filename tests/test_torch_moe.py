"""The port's sort-dispatched MoE (``models/layers.py::moe_apply``) and the
non-gated GELU MLP against the reference's, for the reduced granite-moe
and phi3.5-moe configs.

Layer weights are the reference's ``meta.init_params`` draws carried
across as numpy; inputs come from ``np.random.default_rng``.  Tolerances:
y within 1e-5 and the aux loss within 1e-6 of the reference's (f32, the
same operations in another order); the no-drop case within the reference
test's 1e-4 of the dense mixture.  Drops must hit the same rows: a token
over its expert's capacity is dropped by the stable sort's order, so a
port that sorted unstably or clamped the drop slot would zero other rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.models import layers as JL
from repro.models import meta as JM
from repro_torch.configs import get_config
from repro_torch.models import layers as L

MOE = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]
Y_ATOL = 1e-5
AUX_ATOL = 1e-6
DENSE_ATOL = 1e-4


def _layer0(ref_cfg, block, seed=0):
    """(reference, port) layer-0 weights of ``block``."""
    tree = jax.tree.map(lambda a: np.asarray(a[0]), JM.init_params(
        ref_cfg, jax.random.PRNGKey(seed))["layers"][block])
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _cfgs(arch, **change):
    return (dataclasses.replace(ref_get_config(arch).reduced(), **change),
            dataclasses.replace(get_config(arch).reduced(), **change))


def _dense_mixture(cfg, p, x):
    """Every token through all its top-k experts, weighted: the MoE with
    no capacity limit."""
    probs = torch.softmax(torch.einsum("bsd,de->bse", x, p["router"]), -1)
    topw, topi = torch.topk(probs, cfg.top_k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True)
    h = torch.einsum("bsd,edf->bsef", x, p["wi"])
    g = torch.einsum("bsd,edf->bsef", x, p["wg"])
    out_e = torch.einsum("bsef,efd->bsed", F.silu(g) * h, p["wo"])
    w_e = torch.einsum("bske,bsk->bse",
                       F.one_hot(topi, cfg.num_experts).float(), topw)
    return torch.einsum("bsed,bse->bsd", out_e, w_e)


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["default", "tight"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_reference(arch, cf):
    """y, aux and the dropped rows equal the reference's, at the default
    capacity factor and at a tight one that drops tokens."""
    ref_cfg, cfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _layer0(ref_cfg, "moe")
    x = _x(1, (2, 48, cfg.d_model))
    want, want_aux = JL.moe_apply(ref_cfg, jp, jnp.asarray(x))
    got, aux = L.moe_apply(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=Y_ATOL,
                               rtol=0)
    assert abs(float(aux) - float(want_aux)) < AUX_ATOL
    dense = _dense_mixture(cfg, tp, torch.from_numpy(x)).numpy()
    dropped = np.abs(got.numpy() - dense).max(-1) > DENSE_ATOL
    want_dropped = np.abs(np.asarray(want) - dense).max(-1) > DENSE_ATOL
    np.testing.assert_array_equal(dropped, want_dropped)
    assert dropped.any() == (cf < 1.0)


@pytest.mark.parametrize("arch", MOE)
def test_moe_no_drop_matches_dense(arch):
    """With capacity for every choice, the MoE is the dense mixture."""
    _, cfg = _cfgs(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    _, tp = _layer0(ref_get_config(arch).reduced(), "moe")
    x = torch.from_numpy(_x(2, (2, 16, cfg.d_model), 0.5))
    y, aux = L.moe_apply(cfg, tp, x)
    assert float((y - _dense_mixture(cfg, tp, x)).abs().max()) < DENSE_ATOL
    assert 0.5 < float(aux) < 4.0          # balanced-ish at random init


def test_moe_capacity_drops_some_tokens_when_tight():
    _, cfg = _cfgs("granite-moe-1b-a400m", capacity_factor=0.1)
    _, tp = _layer0(ref_get_config("granite-moe-1b-a400m").reduced(), "moe")
    x = torch.from_numpy(_x(3, (2, 64, cfg.d_model)))
    y, _ = L.moe_apply(cfg, tp, x)
    diff = (y - _dense_mixture(cfg, tp, x)).abs().amax(-1)
    assert float((diff > DENSE_ATOL).float().mean()) > 0.05


@pytest.mark.parametrize("cf,S,K,E,want", [
    (1.25, 1024, 8, 32, 320), (1.25, 1024, 2, 16, 160), (1.25, 1, 8, 32, 8),
    (0.1, 64, 2, 4, 8), (1.25, 48, 2, 4, 32), (0.25, 48, 2, 4, 8),
    (1.25, 700, 8, 32, 224), (4.0, 16, 2, 4, 32)])
def test_moe_capacity_is_the_references_integer(cf, S, K, E, want):
    """max(8, ceil(cf * S * K / E) rounded up to a multiple of 8), the
    reference's expression, at granite's and phi3.5's full-width
    prefills, a decode step and the test shapes."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              capacity_factor=cf, top_k=K, num_experts=E)
    assert L.moe_capacity(cfg, S) == want


def test_moe_grad_flows_to_all_parts():
    """Autograd reaches the router (through the renormalised top-k weights
    and the aux loss), wi, wg and wo."""
    _, cfg = _cfgs("granite-moe-1b-a400m")
    _, tp = _layer0(ref_get_config("granite-moe-1b-a400m").reduced(), "moe")
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    x = torch.from_numpy(_x(4, (2, 16, cfg.d_model)))
    y, aux = L.moe_apply(cfg, tp, x)
    (torch.sum(y ** 2) + 0.01 * aux).backward()
    for name in ("router", "wi", "wg", "wo"):
        assert float(tp[name].grad.abs().max()) > 0, f"no grad to {name}"


def test_gelu_mlp_matches_reference_tanh_approximation():
    """whisper's non-gated MLP: gelu(x wi) wo with ``jax.nn.gelu``'s
    default tanh approximation (the exact erf GELU would miss it)."""
    ref_cfg = ref_get_config("whisper-large-v3").reduced()
    cfg = get_config("whisper-large-v3").reduced()
    jp, tp = _layer0(ref_cfg, "mlp")
    assert sorted(tp) == ["wi", "wo"]
    x = _x(5, (2, 9, cfg.d_model), 3.0)
    want = np.asarray(JL.mlp_apply(ref_cfg, jp, jnp.asarray(x)))
    got = L.mlp_apply(cfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    h = torch.from_numpy(x) @ tp["wi"]
    exact = (F.gelu(h) @ tp["wo"]).numpy()
    assert np.abs(exact - want).max() > 1e-6
