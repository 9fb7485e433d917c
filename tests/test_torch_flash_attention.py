"""The port's attention against the reference's flash-attention path.

``flash_attention_torch`` (what the port's wrapper runs for CPU tensors,
and what the CUDA kernel is held against on the card) against
``repro.kernels.ops.flash_attention`` — the Pallas kernel in interpret
mode, as ``tests/test_flash_attention.py`` runs it — and against the
reference's unfused oracle ``ref.mha_ref``, at every case of that file.
Both sides get the same inputs, drawn by numpy from a fixed seed (bf16
inputs are the f32 draws rounded to bf16 on each side).  Tolerances are
the reference file's: 2e-5 in f32 (the same f32 function, sums in another
order), 2e-2 in bf16 (the output is rounded to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops


def _qkv(seed, B, H, KV, Sq, Sk, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]


def _both(arrays, bf16=False):
    """The same numpy inputs as JAX arrays and torch tensors, f32 or
    rounded to bf16 on each side."""
    if not bf16:
        return ([jnp.asarray(a) for a in arrays],
                [torch.from_numpy(a) for a in arrays])
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _port(tq, causal):
    return ops.flash_attention(*tq, causal=causal, block_q=64, block_k=64,
                               device="cpu")


def _check(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 2, 2, 128, 32),      # MHA, exact blocks
    (2, 4, 2, 256, 64),      # GQA 2:1
    (1, 8, 2, 128, 32),      # GQA 4:1
    (1, 2, 1, 192, 16),      # the reference pads (192 % 128 != 0)
])
def test_flash_matches_ref_causal(B, H, KV, S, hd):
    jq, tq = _both(_qkv(0, B, H, KV, S, S, hd))
    got = _port(tq, True)
    assert got.shape == (B, H, S, hd) and got.dtype == torch.float32
    _check(got, jops.flash_attention(*jq, causal=True, block_q=64,
                                     block_k=64), 2e-5)
    _check(got, ref.mha_ref(*jq, causal=True), 2e-5)


def test_flash_noncausal():
    jq, tq = _both(_qkv(1, 1, 2, 2, 128, 128, 32))
    got = _port(tq, False)
    _check(got, jops.flash_attention(*jq, causal=False, block_q=64,
                                     block_k=64), 2e-5)
    _check(got, ref.mha_ref(*jq, causal=False), 2e-5)


def test_flash_cross_lengths():
    """Sq != Sk: causal masking is top-left aligned (query i sees keys
    0..i), as in the reference."""
    jq, tq = _both(_qkv(2, 1, 4, 4, 64, 256, 32))
    got = _port(tq, True)
    _check(got, jops.flash_attention(*jq, causal=True, block_q=64,
                                     block_k=64), 2e-5)
    _check(got, ref.mha_ref(*jq, causal=True), 2e-5)
    # key 64 and later are invisible to every one of the 64 queries
    pert = [t.clone() for t in tq]
    pert[1][:, :, 64:] = 99.0
    pert[2][:, :, 64:] = -99.0
    assert torch.equal(_port(pert, True), got)


def test_flash_bf16():
    jq, tq = _both(_qkv(3, 1, 2, 2, 128, 128, 32), bf16=True)
    got = _port(tq, True)
    assert got.dtype == torch.bfloat16
    _check(got, jops.flash_attention(*jq, causal=True, block_q=64,
                                     block_k=64), 2e-2)
    _check(got, ref.mha_ref(*jq, causal=True), 2e-2)


def test_flash_causality_property():
    """Perturbing a future key must not change earlier outputs."""
    _, tq = _both(_qkv(4, 1, 2, 2, 128, 128, 32))
    base = _port(tq, True).numpy()
    k2, v2 = tq[1].clone(), tq[2].clone()
    k2[:, :, -1, :] = 99.0
    v2[:, :, -1, :] = -99.0
    pert = _port([tq[0], k2, v2], True).numpy()
    np.testing.assert_allclose(base[:, :, :-1], pert[:, :, :-1],
                               atol=1e-6, rtol=1e-6)
    assert not np.allclose(base[:, :, -1], pert[:, :, -1])


@pytest.mark.parametrize("Sq,Sk,hd", [(1000, 1000, 64), (70, 70, 96),
                                      (5, 5, 256)])
def test_flash_true_lengths_and_head_dims(Sq, Sk, hd):
    """Non-tile lengths and the configs' head dims: the port pads nothing,
    and matches the reference's unfused oracle."""
    jq, tq = _both(_qkv(5, 1, 4, 2, Sq, Sk, hd))
    _check(_port(tq, True), ref.mha_ref(*jq, causal=True), 2e-5)


def test_flash_takes_the_models_layout():
    """A transposed (B, S, H, hd) view gives the contiguous input's
    output, in q's layout."""
    _, tq = _both(_qkv(6, 2, 4, 2, 40, 40, 32))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in tq]
    got = FA.flash_attention(*views)
    assert torch.equal(got, FA.flash_attention(*tq))


def test_flash_wrapper_refusals():
    _, tq = _both(_qkv(7, 1, 2, 2, 8, 8, 264))
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(*tq)
    _, tq = _both(_qkv(7, 1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="group"):
        FA.flash_attention(*tq)
    _, tq = _both(_qkv(7, 1, 2, 2, 8, 8, 16))
    with pytest.raises(TypeError, match="dtype"):
        FA.flash_attention(tq[0].double(), tq[1], tq[2])
    before = FA.LAUNCHES
    FA.flash_attention(*tq)
    assert FA.LAUNCHES == before        # a CPU call never counts


def test_ops_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    _, tq = _both(_qkv(8, 1, 2, 2, 8, 8, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention(*tq)
