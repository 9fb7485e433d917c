"""The port's Mamba-2 SSD (``models/ssm.py``) against the reference's.

The cases of ``tests/test_ssm.py`` with inputs from
``np.random.default_rng`` through both packages: ``ssd_chunked`` and
``ssd_reference`` at the four (Sq, chunk) cases and with an initial
state, each within the reference test's 2e-3 of the reference's own
oracle; the decode chain; ``causal_conv`` with and without a cache;
``ssm_block`` prefill then decode steps on the reference's layer-0
weights of the reduced mamba2 and hymba (within 1e-5); the refusal of a
length that is not a multiple of the chunk; softplus on both sides of
torch's threshold of 20.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.models import meta as JM
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import ssm as S

SSD_ATOL = 2e-3
CONV_ATOL = 1e-5
BLOCK_ATOL = 1e-5


def _inputs(seed, B=2, Sq=64, nh=8, hd=16, G=1, N=16):
    """x, dt, A, Bm, Cm, D as numpy: dt = softplus(normal), A in (-e, -1]."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, Sq, nh, hd)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, Sq, nh)))).astype(f)
    A = -np.exp(rng.uniform(0.0, 1.0, nh)).astype(f)
    Bm = rng.standard_normal((B, Sq, G, N)).astype(f)
    Cm = rng.standard_normal((B, Sq, G, N)).astype(f)
    D = rng.standard_normal(nh).astype(f)
    return x, dt, A, Bm, Cm, D


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _cfgs(arch="mamba2-2.7b", **change):
    return (dataclasses.replace(ref_get_config(arch).reduced(), **change),
            dataclasses.replace(get_config(arch).reduced(), **change))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("Sq,chunk", [(32, 8), (64, 32), (96, 32), (64, 64)])
def test_ssd_chunked_matches_reference(Sq, chunk):
    ref_cfg, cfg = _cfgs(ssm_chunk=chunk)
    j, t = _both(_inputs(0, Sq=Sq))
    want_y, want_s = JS.ssd_reference(ref_cfg, *j)
    y, s = S.ssd_chunked(cfg, *t)
    _close(y, want_y, SSD_ATOL)
    _close(s, want_s, SSD_ATOL)
    y2, s2 = S.ssd_reference(cfg, *t)
    _close(y2, want_y, SSD_ATOL)
    _close(s2, want_s, SSD_ATOL)
    jy, js = JS.ssd_chunked(ref_cfg, *j)
    _close(y, jy, SSD_ATOL)
    _close(s, js, SSD_ATOL)


def test_ssd_with_initial_state():
    ref_cfg, cfg = _cfgs()
    arrays = _inputs(1, Sq=64)
    B, _, nh, hd = arrays[0].shape
    s0 = np.random.default_rng(2).standard_normal(
        (B, nh, hd, arrays[3].shape[-1])).astype(np.float32)
    j, t = _both(arrays)
    want_y, want_s = JS.ssd_reference(ref_cfg, *j,
                                      init_state=jnp.asarray(s0))
    for fn in (S.ssd_chunked, S.ssd_reference):
        y, s = fn(cfg, *t, init_state=torch.from_numpy(s0))
        _close(y, want_y, SSD_ATOL)
        _close(s, want_s, SSD_ATOL)


def test_ssd_decode_chain_matches_chunked():
    """Step-by-step decode over S tokens == the reference's recurrence."""
    ref_cfg, cfg = _cfgs()
    j, t = _both(_inputs(3, Sq=32))
    y_full, s_full = JS.ssd_reference(ref_cfg, *j)
    x, dt, A, Bm, Cm, D = t
    B, Sq, nh, hd = x.shape
    state = torch.zeros((B, nh, hd, Bm.shape[-1]))
    for i in range(Sq):
        y_t, state = S.ssd_decode_step(cfg, state, x[:, i], dt[:, i], A,
                                       Bm[:, i], Cm[:, i], D)
        _close(y_t, y_full[:, i], SSD_ATOL)
    _close(state, s_full, SSD_ATOL)
    y_chunked, _ = S.ssd_chunked(cfg, *t)
    _close(y_chunked, y_full, SSD_ATOL)


@pytest.mark.parametrize("split", [None, 9, 2], ids=["whole", "9+7", "2+14"])
def test_causal_conv_matches_reference(split):
    """Without a cache, and over a stream in two parts carrying the cache
    (a first part shorter than the window too): the reference's outputs
    and caches."""
    rng = np.random.default_rng(4)
    B, Sq, C, W = 2, 16, 8, 4
    x = rng.standard_normal((B, Sq, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if split is None:
        want, want_cache = JS.causal_conv(jnp.asarray(x), jnp.asarray(w))
        got, cache = S.causal_conv(xt, wt)
    else:
        j1, jc = JS.causal_conv(jnp.asarray(x[:, :split]), jnp.asarray(w))
        j2, want_cache = JS.causal_conv(jnp.asarray(x[:, split:]),
                                        jnp.asarray(w), jc)
        want = jnp.concatenate([j1, j2], axis=1)
        t1, tc = S.causal_conv(xt[:, :split], wt)
        _close(tc, jc, CONV_ATOL)
        t2, cache = S.causal_conv(xt[:, split:], wt, tc)
        got = torch.cat([t1, t2], dim=1)
    _close(got, want, CONV_ATOL)
    _close(cache, want_cache, CONV_ATOL)
    whole, _ = S.causal_conv(xt, wt)
    _close(got, whole, CONV_ATOL)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_ssm_block_prefill_then_decode_matches_reference(arch):
    """The full mixer on the reference's layer-0 weights: a 32-token
    prefill, then four decode steps carrying the conv windows and the
    SSD state."""
    ref_cfg, cfg = _cfgs(arch)
    tree = jax.tree.map(lambda a: np.asarray(a[0]), JM.init_params(
        ref_cfg, jax.random.PRNGKey(5))["layers"]["ssm"])
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    x = np.random.default_rng(6).standard_normal(
        (2, 36, cfg.d_model)).astype(np.float32)
    jy, (jconv, jstate) = JS.ssm_block(ref_cfg, jp, jnp.asarray(x[:, :32]))
    ty, (tconv, tstate) = S.ssm_block(cfg, tp, torch.from_numpy(x[:, :32]))
    _close(ty, jy, BLOCK_ATOL)
    _close(tstate, jstate, BLOCK_ATOL)
    for name in ("x", "b", "c"):
        _close(tconv[name], jconv[name], BLOCK_ATOL)
    for i in range(32, 36):
        jy, (jconv, jstate) = JS.ssm_block(
            ref_cfg, jp, jnp.asarray(x[:, i:i + 1]), conv_cache=jconv,
            ssd_state=jstate, decode=True)
        ty, (tconv, tstate) = S.ssm_block(
            cfg, tp, torch.from_numpy(x[:, i:i + 1]), conv_cache=tconv,
            ssd_state=tstate, decode=True)
        _close(ty, jy, BLOCK_ATOL)
        _close(tstate, jstate, BLOCK_ATOL)


@pytest.mark.parametrize("Sq", [33, 40, 100])
def test_ssd_chunked_refuses_a_partial_chunk(Sq):
    """Above one chunk a length must be a multiple of it (the reference
    asserts it; padding would change the final state)."""
    _, cfg = _cfgs(ssm_chunk=32)
    _, t = _both(_inputs(7, Sq=Sq))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        S.ssd_chunked(cfg, *t)
    S.ssd_chunked(dataclasses.replace(cfg, ssm_chunk=Sq), *t)


def test_softplus_matches_jax_above_torch_threshold():
    """dt = softplus(dt_raw + dt_bias): ``jax.nn.softplus`` is
    log(1 + exp(x)) everywhere, the port's ``F.softplus`` returns x itself
    above its threshold of 20.  In f32 the two agree on both sides of the
    threshold (exp(-20) is below half an ulp of 20)."""
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.5, 19.99, 20.0, 20.01, 20.5,
                  25.0, 40.0, 88.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = F.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[x >= 20.0], want[x >= 20.0])
