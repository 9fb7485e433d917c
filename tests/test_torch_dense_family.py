"""The rest of the dense family against the reference: chatglm3's '2d'
RoPE, command-r's LayerNorm and parallel block, and the chunked path's
logit softcap.

Layer functions take inputs from ``np.random.default_rng`` and must agree
within 1e-6 (f32, the same operations in another order).  The reduced
chatglm3-6b and command-r-35b run on the reference's weights, bridged
with ``bridge.params_from_numpy``: prefill logits and four chained decode
steps within 1e-5, and the same greedy tokens — the case of
``tests/test_decode_consistency.py::test_decode_matches_forward`` for
these two architectures, held against the reference's own numbers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from torch_model_cases import as_long, bridged, port_cfg, tokens

DENSE = ["chatglm3-6b", "command-r-35b"]
LAYER_ATOL = 1e-6
MODEL_ATOL = 1e-5


def _rng_f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    ref_cfg = ref_get_config(request.param).reduced()
    jp, tp = bridged(ref_cfg, jax.random.PRNGKey(13), 6)
    return ref_cfg, jp, port_cfg(ref_cfg), tp


def test_configs_have_the_features_ported_for_them():
    glm, cmd = get_config("chatglm3-6b"), get_config("command-r-35b")
    assert (glm.rope_style, glm.num_heads, glm.num_kv_heads, glm.attn_bias,
            glm.head_dim) == ("2d", 32, 2, True, 128)
    assert (cmd.parallel_block, cmd.norm_type, cmd.tie_embeddings,
            cmd.num_heads, cmd.num_kv_heads, cmd.head_dim) == (
        True, "layernorm", True, 64, 8, 128)
    for cfg in (glm, cmd):           # the tree carries what each needs
        got = dict(M.leaves(M.model_meta(cfg)))
        assert ("layers/attn/bq" in got) == cfg.attn_bias
        assert ("layers/norm1/bias" in got) == (cfg.norm_type == "layernorm")


def test_layernorm_matches_reference():
    cfg = get_config("command-r-35b").reduced()
    x = 3.0 * _rng_f32(0, 2, 7, cfg.d_model) + 0.5
    p = {"scale": 1.0 + 0.2 * _rng_f32(1, cfg.d_model),
         "bias": 0.1 * _rng_f32(2, cfg.d_model)}
    want = JL.norm_apply(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = L.norm_apply(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("hd", [64, 128])
def test_rope_2d_matches_reference(hd):
    """'2d' rotates the first half of head_dim as interleaved pairs and
    passes the second half through; per-row positions as decode gives."""
    cfg = dataclasses.replace(get_config("chatglm3-6b").reduced(),
                              head_dim=hd)
    x = _rng_f32(3, 2, 9, 4, hd)
    pos = np.random.default_rng(4).integers(0, 5000, (2, 9)).astype(np.int32)
    jc, js = JL.rope_freqs(cfg, jnp.asarray(pos))
    tc, ts = L.rope_freqs(cfg, _t(pos))
    assert tc.shape == (2, 9, hd // 4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=LAYER_ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=LAYER_ATOL)
    want = JL.apply_rope(cfg, jnp.asarray(x), jc, js)
    got = L.apply_rope(cfg, _t(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=0)
    np.testing.assert_array_equal(got[..., hd // 2:].numpy(),
                                  x[..., hd // 2:])


def test_parallel_block_matches_reference():
    """One command-r decoder block (attention and MLP from one LayerNorm,
    both added to x) on the reference's layer-0 weights."""
    ref_cfg = ref_get_config("command-r-35b").reduced()
    jp, tp = bridged(ref_cfg, jax.random.PRNGKey(1), 2)
    cfg = port_cfg(ref_cfg)
    x = _rng_f32(5, 2, 11, cfg.d_model)
    pos = np.arange(11, dtype=np.int32)
    want, _, _ = JT.decoder_block(
        ref_cfg, jax.tree.map(lambda a: a[0], jp["layers"]), jnp.asarray(x),
        q_pos=jnp.asarray(pos))
    got, aux = T.decoder_block(cfg, M.tree_map(lambda t: t[0], tp["layers"]),
                               _t(x), q_pos=_t(pos))
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=0)


def test_prefill_and_decode_chain_match_reference(model):
    """Prefill logits, then four chained decode steps, within 1e-5 of the
    reference's; each step's greedy token the same."""
    ref_cfg, jp, cfg, tp = model
    toks = tokens(21, (2, 24), cfg.vocab_size)
    jl, jc = JT.prefill(ref_cfg, jp, jnp.asarray(toks[:, :20]),
                        cache_len=28)
    tl, tc = T.prefill(cfg, tp, as_long(toks[:, :20]), cache_len=28)
    for step in range(5):
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, atol=MODEL_ATOL, rtol=0,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      want.argmax(-1))
        if step < 4:
            jl, jc = JT.decode_step(ref_cfg, jp, jc,
                                    jnp.asarray(toks[:, 20 + step]))
            tl, tc = T.decode_step(cfg, tp, tc, as_long(toks[:, 20 + step]))


def test_decode_matches_forward(model):
    """prefill(S-1) + decode(1) == forward(S) at the last position, inside
    the port (``tests/test_decode_consistency.py``'s case)."""
    _, _, cfg, tp = model
    toks = as_long(tokens(22, (2, 24), cfg.vocab_size))
    want = T.lm_logits(cfg, tp, T.forward(cfg, tp, toks)[0])[:, -1]
    _, cache = T.prefill(cfg, tp, toks[:, :-1], cache_len=28)
    got, _ = T.decode_step(cfg, tp, cache, toks[:, -1])
    assert float((want - got).abs().max()) < 2e-4


def test_greedy_tokens_match_reference(model):
    """Eight greedy tokens from cloud-greedy decoding, the same on both
    sides."""
    from repro.core import speculative as JSP
    from repro_torch.core import speculative as SP
    ref_cfg, jp, cfg, tp = model
    prompt = tokens(23, (1, 10), cfg.vocab_size)
    want = JSP.cloud_greedy_generate(ref_cfg, jp, jnp.asarray(prompt), 8)
    got = SP.cloud_greedy_generate(cfg, tp, as_long(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("Sq,Sk", [(24, 24), (1, 24)],
                         ids=["prefill", "decode"])
def test_chunked_softcap_matches_reference(Sq, Sk):
    """``logit_softcap=30`` on the chunked path: scores capped by
    30 tanh(s / 30) after masking, as the reference does."""
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                              logit_softcap=30.0)
    q = _rng_f32(6, 2, Sq, 4, 64)
    k = _rng_f32(7, 2, Sk, 2, 64)
    v = _rng_f32(8, 2, Sk, 2, 64)
    qp = np.arange(Sk - Sq, Sk, dtype=np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    kp[-3:] = -1 if Sq == 1 else kp[-3:]        # unwritten cache slots
    want = JL.attention(cfg, *(jnp.asarray(a) for a in (q, k, v, qp, kp)))
    got = L.attention(cfg, *(_t(a) for a in (q, k, v, qp, kp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=0)
    plain = L.attention(dataclasses.replace(cfg, logit_softcap=0.0),
                        *(_t(a) for a in (q, k, v, qp, kp)))
    assert float((plain - got).abs().max()) > 1e-3     # the cap bit


def test_flash_branch_ignores_softcap_as_the_reference_does():
    """The reference's flash branch (``layers.py:137-144``) does not look at
    ``logit_softcap``; the port's mirrors it: under ``attn_impl="flash"``
    a prefill's attention is the uncapped one on both sides, while the
    chunked path caps."""
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                              logit_softcap=30.0, attn_impl="flash")
    q = _rng_f32(9, 1, 16, 4, 64)
    k = _rng_f32(10, 1, 16, 2, 64)
    v = _rng_f32(11, 1, 16, 2, 64)
    pos = np.arange(16, dtype=np.int32)
    args = (q, k, v, pos, pos)
    want = JL.attention(cfg, *(jnp.asarray(a) for a in args))
    got = L.attention(cfg, *(_t(a) for a in args))
    uncapped = L.attention(dataclasses.replace(cfg, logit_softcap=0.0),
                           *(_t(a) for a in args))
    capped = L.attention(dataclasses.replace(cfg, attn_impl="chunked"),
                         *(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_ATOL)
    np.testing.assert_allclose(got.numpy(), uncapped.numpy(), atol=MODEL_ATOL)
    assert float((capped - got).abs().max()) > 1e-3
