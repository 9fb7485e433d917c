"""The port's CQ classifier against the reference's, on the reference's
weights carried across through numpy (``bridge.cq_params_from_numpy``).

The reference initialises with a JAX PRNG key, which torch cannot
reproduce, so every score-parity check here scores with the reference's
``M.init_params(cfg, PRNGKey(0))``.  Confidences agree within
``CONF_ATOL`` = 1e-5: both sides compute in f32, and the matmuls and
softmax sums run in another order (XLA vs PyTorch's CPU kernels); the
largest gap seen on these inputs is below 1e-6.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.cascade import confidence_from_logits as ref_conf
from repro.kernels import ops as jops
from repro.models import meta as JM
from repro.models import transformer as JT
from repro.system.pixel_frontend import PixelFrontend as RefPixelFrontend
from repro.system.pixel_frontend import _conf_apply
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data import synthetic_video as SV
from repro_torch.kernels import ops
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from repro_torch.system.pixel_frontend import PixelFrontend, cq_config

CONF_ATOL = 1e-5


@pytest.fixture(scope="module")
def ref_fe():
    return RefPixelFrontend(seed=0)


@pytest.fixture(scope="module")
def bridged(ref_fe):
    return bridge.cq_params_from_numpy(
        jax.tree.map(np.asarray, ref_fe.params))


def _tokens(seed, n):
    rng = np.random.default_rng(seed)
    crops = np.stack([SV.object_crop(c % SV.NUM_CLASSES, rng)
                      for c in range(n)])
    return SV.crops_to_tokens(crops, cq_config().vocab_size)


def _ref_cfg():
    full = ref_get_config("surveiledge-cls")
    return dataclasses.replace(full.edge_variant(), num_query_classes=2,
                               vocab_size=full.vocab_size)


def test_config_is_the_references():
    assert dataclasses.asdict(cq_config()) == dataclasses.asdict(_ref_cfg())
    cfg = cq_config()
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (2, 256, 4, 64, 512, 4096)


def test_other_archs_name_the_llm_slice():
    # every assigned LLM is registered beside the CQ model; a name that is
    # not registered is refused
    assert get_config("qwen3-8b").name == "qwen3-8b"
    assert get_config("phi3.5-moe-42b-a6.6b").is_moe
    with pytest.raises(NotImplementedError, match="not in the port"):
        get_config("phi3.5-moe-42b-a6.6b-smoke")


def test_meta_matches_reference_tree():
    cfg = cq_config()
    ref_meta = JM.model_meta(_ref_cfg())
    ref_leaves = jax.tree_util.tree_leaves_with_path(
        ref_meta, is_leaf=lambda x: isinstance(x, JM.ParamMeta))
    ref_shapes = {"/".join(k.key for k in path): m.shape
                  for path, m in ref_leaves}
    port_shapes = {p: m.shape for p, m in M.leaves(M.model_meta(cfg))}
    assert port_shapes == ref_shapes


def test_port_init_is_seeded_with_reference_scales():
    cfg = cq_config()
    a = M.init_params(cfg, torch.Generator().manual_seed(0))
    b = M.init_params(cfg, torch.Generator().manual_seed(0))
    c = M.init_params(cfg, torch.Generator().manual_seed(1))
    for (pa, ta), (_, tb), (_, tc) in zip(M.leaves(a), M.leaves(b),
                                          M.leaves(c)):
        assert torch.equal(ta, tb), pa
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["layers"]["norm1"]["scale"],
                       torch.ones(cfg.num_layers, cfg.d_model))
    assert torch.equal(a["cls_head"]["b"], torch.zeros(2))
    # N(0, 1/sqrt(D)) embedding, N(0, 0.02) projections
    assert abs(float(a["embed"].std()) - cfg.d_model ** -0.5) < 2e-3
    assert abs(float(a["layers"]["attn"]["wq"].std()) - 0.02) < 1e-3


def test_bridge_checks_every_shape(ref_fe):
    tree = jax.tree.map(np.asarray, ref_fe.params)
    bad = jax.tree.map(lambda x: x, tree)
    bad["layers"]["mlp"]["wi"] = bad["layers"]["mlp"]["wi"][:, :, :8]
    with pytest.raises(ValueError, match="mlp/wi"):
        bridge.cq_params_from_numpy(bad)
    missing = {k: v for k, v in tree.items() if k != "cls_head"}
    with pytest.raises(ValueError, match="cls_head"):
        bridge.cq_params_from_numpy(missing)


@pytest.mark.parametrize("n", [1, 13, 40])
def test_confidences_match_reference(ref_fe, bridged, n):
    tokens = _tokens(n, n)
    want = np.asarray(_conf_apply(ref_fe.cfg, ref_fe.params,
                                  jax.numpy.asarray(tokens)))
    model = T.CQClassifier(cq_config(), bridged, device="cpu")
    got = model(torch.from_numpy(tokens).long()).numpy()
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=0, atol=CONF_ATOL)
    # logits too, through the port's forward + classify
    h, _ = JT.forward(ref_fe.cfg, ref_fe.params, jax.numpy.asarray(tokens))
    want_logits = np.asarray(JT.classify(ref_fe.cfg, ref_fe.params, h))
    got_logits = T.classify(model.cfg, model.params, T.forward(
        model.cfg, model.params, torch.from_numpy(tokens).long())[0]).numpy()
    np.testing.assert_allclose(got_logits, want_logits, rtol=0,
                               atol=CONF_ATOL)
    np.testing.assert_allclose(
        np.asarray(ref_conf(jax.numpy.asarray(want_logits), 1)),
        got, rtol=0, atol=CONF_ATOL)


def test_score_crops_padding_is_invisible(bridged):
    """13 crops launch at the bucket shape 16; the first 13 scores equal
    an unpadded call, and the reference's wrapper pads the same way."""
    fe = PixelFrontend(params=bridged, device="cpu")
    tokens = _tokens(2, 13)
    seen = []

    def spy(t):
        seen.append(tuple(t.shape))
        return fe.model(t)

    got = ops.score_crops(spy, tokens, device="cpu")
    assert seen == [(16, tokens.shape[1])]
    assert got.shape == (13,)
    direct = fe.model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=0,
                               atol=1e-6)
    ref_seen = []
    jops.score_crops(lambda t: ref_seen.append(t.shape) or t[:, 0] * 0.0,
                     tokens)
    assert ref_seen == [(16, tokens.shape[1])]


def test_default_classifier_runs_on_the_card_or_refuses():
    if torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        PixelFrontend()
    fe = PixelFrontend(device="cpu", seed=5)
    conf = ops.score_crops(fe.model, _tokens(3, 5), device="cpu")
    assert conf.shape == (5,)
    assert bool(((conf >= 0) & (conf <= 1)).all())
