"""The six model families the dense slice lacked, against the reference:
granite-moe and phi3.5-moe (MoE), mamba2 (SSM), hymba (hybrid), whisper
(encoder-decoder) and internvl2 (image prefix).

The reduced configs run on the reference's weights, bridged with
``bridge.params_from_numpy`` (``torch_model_cases`` perturbs the zero
biases and unit qk-norm scales first); the stub frontends' inputs come
from ``np.random.default_rng``.  Tolerances are the reference tests':
logits within 2e-4 for ``forward``, ``prefill`` and each decode step.
``tests/test_torch_family_decode.py`` holds whisper's cross-attention
cache and internvl2's image prefix against the reference, and runs the
reference's decode checks inside the port for every ``ASSIGNED`` config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import meta as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from torch_model_cases import as_long, bridged, port_cfg, tokens

FAMILIES = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
            "hymba-1.5b", "whisper-large-v3", "internvl2-1b"]
STEP_ATOL = 2e-4


def _stubs(cfg, B, seed, scale=1.0):
    """(reference kwargs, port kwargs): the stub frontends' outputs."""
    rng = np.random.default_rng(seed)
    arrays = {}
    if cfg.num_img_tokens:
        arrays["img_embeds"] = rng.standard_normal(
            (B, cfg.num_img_tokens, 1024))
    if cfg.is_encdec:
        arrays["audio_frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model))
    arrays = {k: (scale * v).astype(np.float32) for k, v in arrays.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    ref_cfg = ref_get_config(request.param).reduced()
    jp, tp = bridged(ref_cfg, jax.random.PRNGKey(7), 3)
    return ref_cfg, jp, port_cfg(ref_cfg), tp


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# --- configs and parameter trees ------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_configs_and_trees_are_the_references(arch):
    """The config (full, reduced, edge variant) and every leaf's path,
    shape and init rule at full width."""
    for variant in (lambda c: c, lambda c: c.reduced(),
                    lambda c: c.edge_variant()):
        assert dataclasses.asdict(variant(get_config(arch))) == \
            dataclasses.asdict(variant(ref_get_config(arch)))
    ref_leaves = jax.tree_util.tree_leaves_with_path(
        JM.model_meta(ref_get_config(arch)),
        is_leaf=lambda x: isinstance(x, JM.ParamMeta))
    want = {"/".join(k.key for k in path): (m.shape, m.init, m.scale)
            for path, m in ref_leaves}
    got = {p: (m.shape, m.init, m.scale)
           for p, m in M.leaves(M.model_meta(get_config(arch)))}
    assert got == want


# --- the reduced families against the reference ---------------------------------


def test_forward_matches_reference(model):
    ref_cfg, jp, cfg, tp = model
    toks = tokens(1, (2, 32), cfg.vocab_size)
    jkw, tkw = _stubs(cfg, 2, 2)
    h, aux = JT.forward(ref_cfg, jp, jnp.asarray(toks), **jkw)
    want = JT.lm_logits(ref_cfg, jp, h)
    got_h, got_aux = T.forward(cfg, tp, as_long(toks), **tkw)
    _close(T.lm_logits(cfg, tp, got_h), want, STEP_ATOL)
    assert abs(float(got_aux) - float(aux)) < 1e-6
    assert (float(got_aux) > 0) == cfg.is_moe


def test_prefill_and_decode_match_reference(model):
    """Prefill logits and cache (positions, K/V, conv windows, SSD state,
    cross K/V), then three chained decode steps."""
    ref_cfg, jp, cfg, tp = model
    B, S = 2, 16
    toks = tokens(3, (B, S + 3), cfg.vocab_size)
    jkw, tkw = _stubs(cfg, B, 4)
    jl, jc = JT.prefill(ref_cfg, jp, jnp.asarray(toks[:, :S]),
                        cache_len=S + 4, **jkw)
    tl, tc = T.prefill(cfg, tp, as_long(toks[:, :S]), cache_len=S + 4, **tkw)
    _close(tl, jl, STEP_ATOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    want_layers = dict(M.leaves(jax.tree.map(np.asarray, jc["layers"])))
    got_layers = dict(M.leaves(tc["layers"]))
    assert set(got_layers) == set(want_layers)
    for name, want in want_layers.items():
        _close(got_layers[name], want, STEP_ATOL)
    for i in range(S, S + 3):
        jd, jc = JT.decode_step(ref_cfg, jp, jc, jnp.asarray(toks[:, i]))
        td, tc = T.decode_step(cfg, tp, tc, as_long(toks[:, i]))
        _close(td, jd, STEP_ATOL)
        np.testing.assert_array_equal(tc["kpos"].numpy(),
                                      np.asarray(jc["kpos"]))
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
