"""int8 weights and the int8 KV cache against the reference's.

The cases of ``tests/test_quantize.py`` for the dense architectures the
port runs (qwen3-8b, chatglm3-6b, command-r-35b in place of the MoE and
hybrid ones), each also held against the reference's numbers on the same
inputs (weights drawn by the reference and bridged with
``bridge.params_from_numpy``, arrays from ``np.random.default_rng``):

* on the same float input, the port's int8 values equal the reference's
  and its scales lie within one f32 ulp (``torch.round`` and
  ``jnp.round`` both round half to even);
* with bf16 compute, the int8-weight logits within 1e-2 of the
  reference's int8-weight logits, relative to the largest logit;
* with f32 compute, an int8-KV decode step within 1e-5 of the
  reference's, from the reference's own prefill cache.  A whole
  prefill-then-decode run cannot be held that tightly: its K/V differ
  from the reference's by f32 ulps, and a value whose pre-image lies that
  close to a rounding boundary rounds to the neighbouring int8 step on
  one side (about one value in 20,000 here, each moving the logits by up
  to ~2e-4), so the prefill caches are compared step by step instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed import quantize as JQ
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.distributed import quantize as QZ
from repro_torch.models import layers as L
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from torch_model_cases import as_long, bridged, port_cfg, tokens

DENSE = ["qwen3-8b", "chatglm3-6b", "command-r-35b"]
#: int8-weight logits (bf16 compute) against the reference's, relative to
#: the largest: bf16 rounds every product's output to 8 bits
INT8_WEIGHT_RTOL = 1e-2
#: int8-KV decode logits (f32 compute) against the reference's
INT8_KV_ATOL = 1e-5


def _rng_f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _same_int8(got, want, what=""):
    """int8 values equal; scales within one f32 ulp."""
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]),
                                  err_msg=what)
    np.testing.assert_array_max_ulp(got["s"].numpy(), np.asarray(want["s"]),
                                    maxulp=1)


def _bf16(tree):
    return M.tree_map(lambda t: t.to(torch.bfloat16), tree)


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    ref_cfg = ref_get_config(request.param).reduced()
    jp, tp = bridged(ref_cfg, jax.random.PRNGKey(0), 8)
    return ref_cfg, jp, port_cfg(ref_cfg), tp


@pytest.mark.parametrize("stacked", [True, False])
def test_quantize_roundtrip_error_bound(stacked):
    x = 3.0 * _rng_f32(0, 4, 64, 32)
    q = QZ.quantize_leaf(torch.from_numpy(x), stacked=stacked)
    _same_int8(q, JQ.quantize_leaf(jnp.asarray(x), stacked=stacked))
    back = QZ.dequantize_leaf(q, torch.float32)
    # symmetric int8: error <= scale/2 per element
    bound = (q["s"].reshape(4, 1, 32) if stacked else q["s"]) / 2 + 1e-6
    assert bool(((back - torch.from_numpy(x)).abs() <= bound).all())
    assert q["q"].dtype == torch.int8
    assert q["s"].shape == ((4, 32) if stacked else (32,))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JQ.dequantize_leaf(
            JQ.quantize_leaf(jnp.asarray(x), stacked=stacked), jnp.float32)))


def test_quantize_tree_skips_norms_and_keeps_scan_axis(model):
    ref_cfg, jp, cfg, tp = model
    qp = QZ.quantize_tree(tp, cfg)
    want = JQ.quantize_tree(jp, ref_cfg)
    # norms and biases stay float, every weight leaf is the reference's
    assert not isinstance(qp["layers"]["norm1"]["scale"], dict)
    for path, _ in M.leaves(M.model_meta(cfg)):
        node, ref = qp, want
        for key in path.split("/"):
            node, ref = node[key], ref[key]
        assert isinstance(node, dict) == isinstance(ref, dict), path
        if isinstance(node, dict):
            _same_int8(node, ref, path)
        else:
            np.testing.assert_array_equal(node.numpy(), np.asarray(ref))
    wq = qp["layers"]["attn"]["wq"]
    assert wq["q"].dtype == torch.int8
    assert wq["q"].shape[0] == wq["s"].shape[0] == cfg.num_layers
    # dequant restores structure
    back = QZ.dequant_tree(qp, torch.float32)
    assert back["layers"]["attn"]["wq"].shape == \
        tp["layers"]["attn"]["wq"].shape


def test_layer_slice_dequantizes_as_the_scan_body_sees_it(model):
    """A stacked leaf's (L, out) scale is sliced to (out,) with its layer:
    ``maybe_dequant`` of layer i's slice equals row i of the reference's
    dequantized stack, which is what its ``lax.scan`` body computes."""
    ref_cfg, jp, cfg, tp = model
    want = JQ.dequant_tree(JQ.quantize_tree(jp, ref_cfg), jnp.float32)
    qp = QZ.quantize_tree(tp, cfg)
    for i in range(cfg.num_layers):
        got = T.maybe_dequant(M.tree_map(lambda t: t[i], qp["layers"]),
                              torch.float32)
        for path, leaf in M.leaves(got):
            ref = want["layers"]
            for key in path.split("/"):
                ref = ref[key]
            np.testing.assert_allclose(leaf.numpy(), np.asarray(ref[i]),
                                       rtol=2.0 ** -22, atol=0, err_msg=path)


def test_int8_weights_forward_close(model):
    """bf16 weights quantized to int8 compute in bf16; their logits stay
    within the reference test's 6% of the bf16 model's, and within 1e-2 of
    the reference's int8-weight logits."""
    ref_cfg, jp, cfg, tp = model
    toks = tokens(1, (2, 24), cfg.vocab_size)
    jq = JQ.quantize_tree(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
                          ref_cfg)
    h, _ = JT.forward(ref_cfg, jq, jnp.asarray(toks))
    ref_int8 = np.asarray(JT.lm_logits(ref_cfg, jq, h).astype(jnp.float32))
    params = _bf16(tp)
    want = T.lm_logits(cfg, params, T.forward(cfg, params, as_long(toks))[0])
    qp = QZ.quantize_tree(params, cfg)
    hq, _ = T.forward(cfg, qp, as_long(toks))
    assert hq.dtype == torch.bfloat16
    got = T.lm_logits(cfg, qp, hq).float()
    want = want.float()
    rel = float((want - got).abs().max() / want.abs().max())
    assert rel < 0.06, rel
    gap = np.abs(got.numpy() - ref_int8).max() / np.abs(ref_int8).max()
    assert gap < INT8_WEIGHT_RTOL, gap


def test_int8_kv_cache_decode_close(model):
    ref_cfg, jp, cfg, tp = model
    ref_cfg = dataclasses.replace(ref_cfg, kv_cache_dtype="int8")
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    toks = tokens(1, (2, 24), cfg.vocab_size)
    want = T.lm_logits(cfg, tp, T.forward(cfg, tp, as_long(toks))[0])[:, -1]
    _, cache = T.prefill(cfg, tp, as_long(toks[:, :-1]), cache_len=28)
    assert cache["layers"]["k"].dtype == torch.int8
    assert cache["layers"]["k_scale"].dtype == torch.float32
    got, _ = T.decode_step(cfg, tp, cache, as_long(toks[:, -1]))
    rel = float((want - got).abs().max() / want.abs().max())
    assert rel < 0.02, rel
    # against the reference: the prefill caches a step apart at most, on
    # rounding boundaries only; one decode step from the reference's cache
    _, jc = JT.prefill(ref_cfg, jp, jnp.asarray(toks[:, :-1]), cache_len=28)
    _, tc = T.prefill(cfg, tp, as_long(toks[:, :-1]), cache_len=28)
    for name in ("k", "v"):
        diff = np.abs(tc["layers"][name].numpy().astype(np.int32)
                      - np.asarray(jc["layers"][name], np.int32))
        assert diff.max() <= 1 and diff.mean() < 1e-3, (name, diff.sum())
        np.testing.assert_allclose(tc["layers"][name + "_scale"].numpy(),
                                   np.asarray(jc["layers"][name + "_scale"]),
                                   rtol=1e-5, atol=0)
    jd, _ = JT.decode_step(ref_cfg, jp, jc, jnp.asarray(toks[:, -1]))
    td, _ = T.decode_step(cfg, tp, jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), jc), as_long(toks[:, -1]))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=INT8_KV_ATOL,
                               rtol=0)


def test_quantize_kv_roundtrip():
    x = _rng_f32(2, 2, 8, 4, 16)
    q, s = L.quantize_kv(torch.from_numpy(x))
    jq, js = JL.quantize_kv(jnp.asarray(x))
    _same_int8({"q": q, "s": s}, {"q": jq, "s": js})
    back = L.dequantize_kv(q, s, torch.float32)
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        float(s.max()) / 2 + 1e-5
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JL.dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("mode", ["int8_kv", "int8_weights"])
def test_decode_engine_serves_int8_like_the_reference(mode):
    """``DecodeEngine``'s normal admit/step on an int8-KV model (the slot
    copy carries ``k_scale``/``v_scale`` with K/V) and on an int8-weight
    model (bf16 compute into the f32 engine cache, as the reference's
    engine does): the same greedy tokens as the reference's engine on the
    bridged weights."""
    from repro.serving.engine import DecodeEngine as RefDecodeEngine
    from repro.serving.engine import Request as RefRequest
    from repro_torch.serving.engine import DecodeEngine, Request
    ref_cfg = ref_get_config("qwen3-8b").reduced()
    jp, tp = bridged(ref_cfg, jax.random.PRNGKey(4), 9)
    cfg = port_cfg(ref_cfg)
    if mode == "int8_kv":
        ref_cfg = dataclasses.replace(ref_cfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    else:
        jp = JQ.quantize_tree(jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                           jp), ref_cfg)
        tp = QZ.quantize_tree(_bf16(tp), cfg)
    prompts = [tokens(30 + i, (n,), cfg.vocab_size)
               for i, n in enumerate((9, 14, 6))]

    def drive(engine, request):
        for i, p in enumerate(prompts):
            assert engine.admit(request(rid=i, tokens=p, max_new=5))
        outs = {}
        while any(not slot.free for slot in engine.slots):
            for rid, gen in engine.step():
                outs[rid] = [int(t) for t in gen]
        return outs

    eng = DecodeEngine(cfg, tp, slots=3, cache_len=20, device="cpu")
    got = drive(eng, Request)
    layers = eng.cache["layers"]
    if mode == "int8_kv":
        assert layers["k"].dtype == torch.int8
        assert sorted(layers) == ["k", "k_scale", "v", "v_scale"]
        assert bool((layers["k_scale"][:, :3, :6] > 0).all())
    else:
        assert layers["k"].dtype == torch.float32
    want = drive(RefDecodeEngine(ref_cfg, jp, slots=3, cache_len=20),
                 RefRequest)
    assert got == want and all(len(g) == 5 for g in got.values())
