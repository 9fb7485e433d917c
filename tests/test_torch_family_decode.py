"""The reference's decode checks (``tests/test_decode_consistency.py``)
inside the port, on its own seeded init, for every ``ASSIGNED`` config;
the registry's ``list_archs``; the SSM init rules and the attention-free
cache; whisper's cross-attention cache and internvl2's image prefix
against the reference on bridged weights.

Tolerances are the reference tests': 2e-4 for one decode step (against
the forward, or against the reference's step), 5e-4 along a decode
chain.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as REF_ASSIGNED
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models import transformer as JT
from repro_torch.configs import ASSIGNED, get_config, list_archs
from repro_torch.models import layers as L
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from torch_model_cases import as_long, bridged, port_cfg, tokens

STEP_ATOL = 2e-4
CHAIN_ATOL = 5e-4


def _stubs(cfg, B, seed, scale=0.1):
    """(reference kwargs, port kwargs): the stub frontends' outputs the
    config takes."""
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


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_list_archs_is_the_references():
    assert list_archs() == ref_list_archs() == list(REF_ASSIGNED) == ASSIGNED


def test_ssm_time_constants_follow_the_reference_init():
    """``a_log`` = log U[1, 16) and ``dt_bias`` = softplus^-1 of a dt
    log-uniform in [1e-3, 1e-1], drawn on the generator's device."""
    cfg = get_config("mamba2-2.7b").reduced()
    ssm = M.init_params(cfg, torch.Generator().manual_seed(0))["layers"]["ssm"]
    A = torch.exp(ssm["a_log"])
    dt = torch.log1p(torch.exp(ssm["dt_bias"]))
    assert float(A.min()) >= 1.0 and float(A.max()) < 16.0
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert bool((ssm["d_skip"] == 1).all())


# --- the reference's decode checks, inside the port --------------------------------


@pytest.mark.parametrize("arch", ASSIGNED)
def test_decode_matches_forward(arch):
    """prefill(S-1) + decode(1) == forward(S) at the last position, for
    every assigned config (MoE without drops, as the reference's test)."""
    cfg = get_config(arch).reduced()
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    params = M.init_params(cfg, torch.Generator().manual_seed(3))
    B, S = 2, 24
    toks = as_long(tokens(11, (B, S), cfg.vocab_size))
    _, kw = _stubs(cfg, B, 12)
    h, _ = T.forward(cfg, params, toks, **kw)
    want = T.lm_logits(cfg, params, h)[:, -1]
    _, cache = T.prefill(cfg, params, toks[:, :-1], cache_len=S + 4, **kw)
    got, _ = T.decode_step(cfg, params, cache, toks[:, -1])
    assert float((want - got).abs().max()) < STEP_ATOL


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_multi_step_decode_chain(arch):
    """Decoding token by token equals the full forward's logits."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(4))
    B, S = 2, 16
    toks = as_long(tokens(13, (B, S), cfg.vocab_size))
    want = T.lm_logits(cfg, params, T.forward(cfg, params, toks)[0])
    _, cache = T.prefill(cfg, params, toks[:, :4], cache_len=S)
    for i in range(4, S):
        got, cache = T.decode_step(cfg, params, cache, toks[:, i])
        err = float((want[:, i] - got).abs().max())
        assert err < CHAIN_ATOL, (i, err)


def test_mamba2_cache_has_no_attention():
    """An attention-free model's cache: conv windows and SSD state, no
    K/V, and ``kpos`` left as it is by decode (the reference updates it
    only with attention)."""
    cfg = get_config("mamba2-2.7b").reduced()
    cache = T.make_cache(cfg, 2, 8, device="cpu")
    assert sorted(cache["layers"]) == ["conv", "ssd"]
    assert sorted(cache["layers"]["conv"]) == ["b", "c", "x"]
    assert cache["layers"]["ssd"].shape == (2, 2, cfg.ssm_heads,
                                            cfg.ssm_headdim, cfg.ssm_state)
    assert bool((cache["kpos"] == 0).all())
    params = M.init_params(cfg, torch.Generator().manual_seed(5))
    _, cache = T.prefill(cfg, params, as_long(tokens(14, (2, 8), 512)),
                         cache_len=12)
    kpos = cache["kpos"].clone()
    _, cache = T.decode_step(cfg, params, cache, torch.tensor([1, 2]))
    assert torch.equal(cache["kpos"], kpos)
    assert cache["pos"].tolist() == [9, 9]


def test_whisper_decode_reuses_the_cross_attention_cache():
    """Prefill writes each layer's cross K/V (the encoder output's
    projection, Se = enc_seq rows); decode reads them and leaves them as
    they were, and its logits follow the reference's."""
    ref_cfg = ref_get_config("whisper-large-v3").reduced()
    jp, tp = bridged(ref_cfg, jax.random.PRNGKey(8), 5)
    cfg = port_cfg(ref_cfg)
    jkw, tkw = _stubs(cfg, 1, 6, scale=1.0)
    toks = tokens(7, (1, 12), cfg.vocab_size)
    _, cache = T.prefill(cfg, tp, as_long(toks[:, :8]), cache_len=16, **tkw)
    enc = T.encode(cfg, tp, tkw["audio_frames"])
    lp = M.tree_map(lambda t: t[1], tp["layers"])["cross"]
    want_k = L.einsum("bsd,dhk->bshk", enc, lp["wk"]) + lp["bk"]
    assert cache["layers"]["cross_k"].shape[2] == cfg.enc_seq
    _close(cache["layers"]["cross_k"][1], want_k, 1e-5)
    cross = {k: cache["layers"][k].clone() for k in ("cross_k", "cross_v")}
    _, jc = JT.prefill(ref_cfg, jp, jnp.asarray(toks[:, :8]), cache_len=16,
                       **jkw)
    for i in range(8, 12):
        got, cache = T.decode_step(cfg, tp, cache, as_long(toks[:, i]))
        want, jc = JT.decode_step(ref_cfg, jp, jc, jnp.asarray(toks[:, i]))
        _close(got, want, STEP_ATOL)
    for k, v in cross.items():
        assert torch.equal(cache["layers"][k], v)


def test_internvl2_cache_counts_the_image_prefix():
    """A text cache_len gains the num_img_tokens prefix, as the
    reference's prefill adds it; positions count the prefix too."""
    ref_cfg = ref_get_config("internvl2-1b").reduced()
    cfg = get_config("internvl2-1b").reduced()
    jp, tp = bridged(ref_cfg, jax.random.PRNGKey(9), 8)
    jkw, tkw = _stubs(cfg, 2, 9, scale=1.0)
    toks = tokens(10, (2, 10), cfg.vocab_size)
    n = cfg.num_img_tokens
    for cache_len in (None, 14):
        _, jc = JT.prefill(ref_cfg, jp, jnp.asarray(toks), cache_len=cache_len,
                           **jkw)
        _, tc = T.prefill(cfg, tp, as_long(toks), cache_len=cache_len, **tkw)
        want_len = (cache_len or 10) + n
        assert tc["kpos"].shape == (2, want_len) == jc["kpos"].shape
        assert tc["layers"]["k"].shape[2] == want_len
        assert tc["pos"].tolist() == [10 + n] * 2 == jc["pos"].tolist()
        np.testing.assert_array_equal(tc["kpos"].numpy(),
                                      np.asarray(jc["kpos"]))
    with pytest.raises(ValueError, match="img_embeds"):
        T.prefill(cfg, tp, as_long(toks))
