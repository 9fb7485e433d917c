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
import math

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


# ---------------------------------------------------------------------------
# The card's f32 kernel (head dims 64 and 128) multiplies on the tensor
# cores in split TF32.  These tests emulate its arithmetic on the CPU.
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to TF32 (10 mantissa bits) to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``: add half a TF32 ulp to the magnitude's bits and
    clear the 13 bits below it."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _attention_tf32(q, k, v, causal, split=True):
    """The kernel's arithmetic in plain PyTorch: q * 1/sqrt(hd) in f32,
    every product of TF32 parts (exact in f32) summed in f32 — hi*hi +
    hi*lo + lo*hi with ``split``, hi*hi alone without — and the
    unnormalised probabilities split before the product with V."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    x = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, KV, G, Sq, hd)
    qh, ql = _split(x)
    kh, kl = _split(k.float())
    vh, vl = _split(v.float())

    def prod(a_hi, a_lo, b_hi, b_lo, eq):
        out = torch.einsum(eq, a_hi, b_hi)
        if split:
            out = out + torch.einsum(eq, a_hi, b_lo) + torch.einsum(
                eq, a_lo, b_hi)
        return out

    s = prod(qh, ql, kh, kl, "bkgqh,bksh->bkgqs")
    if causal:
        mask = torch.arange(Sq)[:, None] >= torch.arange(Sk)[None, :]
        s = torch.where(mask, s, FA.NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    eh, el = _split(e)
    o = prod(eh, el, vh, vl, "bkgqs,bksh->bkgqh") / e.sum(-1, keepdim=True)
    return o.reshape(B, H, Sq, hd)


def test_tf32_rounding_is_round_to_nearest_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-3])
    got = _tf32(x)
    assert got[0] == 1.0 + 2.0 ** -10          # a tie rounds away from 0
    assert got[1] == 1.0 + 2.0 ** -9
    assert got[2] == -(1.0 + 2.0 ** -10)
    assert got[3] == 1.0
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(got[4]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal", [
    (1, 2, 2, 128, 128, 32, True),     # the reference file's f32 cases
    (2, 4, 2, 256, 256, 64, True),
    (1, 8, 2, 128, 128, 32, True),
    (1, 2, 1, 192, 192, 16, True),
    (1, 2, 2, 128, 128, 32, False),
    (1, 4, 4, 64, 256, 32, True),
    (1, 4, 4, 1024, 1024, 64, True),   # qwen1.5-0.5b's prefill, 4 heads
])
def test_split_tf32_holds_the_f32_tolerance(B, H, KV, Sq, Sk, hd, causal):
    """The card kernel's split scheme (3xTF32) stays within the f32
    tolerance (2e-5) of the plain f32 version.  The emulation rounds every
    sum to nearest; the tensor cores' f32 accumulation, which rounds less
    well, is not modelled, so this does not bound the card's error."""
    _, tq = _both(_qkv(9, B, H, KV, Sq, Sk, hd))
    want = FA.flash_attention_torch(*tq, causal)
    got = _attention_tf32(*tq, causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_plain_tf32_misses_the_f32_tolerance():
    """Why the split is there: one TF32 product each misses 2e-5 by far
    at qwen1.5-0.5b's 1,024-token prefill."""
    _, tq = _both(_qkv(9, 1, 4, 4, 1024, 1024, 64))
    want = FA.flash_attention_torch(*tq, True)
    err = float((_attention_tf32(*tq, True, split=False) - want).abs().max())
    assert err > 10 * 2e-5
