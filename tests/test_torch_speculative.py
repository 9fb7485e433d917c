"""Cascade speculative decoding: the port against cloud-greedy decoding and
against the reference's ``core/speculative.py``.

The cases of ``tests/test_speculative.py`` run inside the port on its own
seeded init.  Against the reference, the reduced qwen1.5-0.5b and qwen3-8b
clouds and their edge variants run on the reference's weights (drawn by
the reference, bridged with ``bridge.params_from_numpy``), for k in {1,
3, 4}.  The reference's loop appends the last draft token a second time
after a round whose proposals all match (ROADMAP "Faults"), and the port
does not, so the oracle is the reference's loop rebuilt in this file
from the reference's own ``prefill``, ``draft_tokens``, ``decode_step``
and ``verify_prefix`` with that one step repaired: the port's tokens and
``SpecStats`` (proposed, accepted, cloud steps, cloud tokens) must equal
the oracle's, and its tokens the reference's ``cloud_greedy_generate``.
The models are f32 on both sides and their logits agree to ~1e-6, so no
near-tie flip is excused.

At the reference's init scale a reduced model's greedy token is its
input token (the trunk adds little to the embedding), so every draft is
accepted and the rejection path never runs.  The bridged cloud's layer
matrices are therefore scaled by ``GAIN``, and its draft is the cloud
distilled: the same layer tables plus ``DRAFT_NOISE`` of each one's
standard deviation in noise, the edge variant's shapes being the reduced
cloud's.  Its proposals are accepted about a fifth to three quarters of
the time.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import speculative as JSP
from repro.models import meta as JM
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import speculative as SP
from repro_torch.models import meta as M
from torch_model_cases import as_long, perturbed, port_cfg, tokens

ROOT = Path(__file__).resolve().parents[1]
STEPS = 8
GAIN = 3.0
DRAFT_NOISE = 0.1


@pytest.fixture(scope="module")
def pair():
    cloud_cfg = get_config("qwen1.5-0.5b").reduced()
    edge_cfg = get_config("qwen1.5-0.5b").edge_variant()
    cloud = M.init_params(cloud_cfg, torch.Generator().manual_seed(0))
    edge = M.init_params(edge_cfg, torch.Generator().manual_seed(1))
    return edge_cfg, edge, cloud_cfg, cloud


def test_speculative_equals_cloud_greedy(pair):
    edge_cfg, edge, cloud_cfg, cloud = pair
    prompt = as_long(tokens(2, (1, 12), cloud_cfg.vocab_size))
    want = SP.cloud_greedy_generate(cloud_cfg, cloud, prompt, steps=10)
    got, stats = SP.speculative_generate(edge_cfg, edge, cloud_cfg, cloud,
                                         prompt, steps=10, k=3)
    assert torch.equal(got, want)
    assert stats.proposed >= stats.accepted >= 0
    assert stats.cloud_steps >= 1


def test_speculative_self_draft_accepts_everything(pair):
    """Drafting with the cloud model itself must accept every proposal."""
    _, _, cloud_cfg, cloud = pair
    prompt = as_long(tokens(3, (1, 8), cloud_cfg.vocab_size))
    got, stats = SP.speculative_generate(cloud_cfg, cloud, cloud_cfg, cloud,
                                         prompt, steps=8, k=4)
    want = SP.cloud_greedy_generate(cloud_cfg, cloud, prompt, steps=8)
    assert torch.equal(got, want)
    assert stats.acceptance_rate == pytest.approx(1.0)
    assert stats.tokens_per_cloud_step > 1.5


def test_verify_prefix_logic():
    V = 16
    draft = torch.tensor([[3, 5, 7]])
    logits = torch.zeros((1, 3, V))
    logits[0, 0, 3] = 9.0     # agrees
    logits[0, 1, 5] = 9.0     # agrees
    logits[0, 2, 9] = 9.0     # disagrees -> cloud says 9
    n, nxt = SP.verify_prefix(logits, draft)
    assert int(n[0]) == 2
    assert int(nxt[0]) == 9
    want_n, want_nxt = JSP.verify_prefix(jnp.asarray(logits.numpy()),
                                         jnp.asarray(draft.numpy()))
    assert (int(want_n[0]), int(want_nxt[0])) == (2, 9)


def test_verify_prefix_matches_reference_on_random_logits():
    rng = np.random.default_rng(4)
    for k in (1, 3, 4):
        logits = rng.standard_normal((3, k, 8)).astype(np.float32)
        draft = logits.argmax(-1).astype(np.int32)
        draft[rng.uniform(size=draft.shape) < 0.3] = 7     # some mismatches
        got = SP.verify_prefix(torch.from_numpy(logits),
                               torch.from_numpy(draft))
        want = JSP.verify_prefix(jnp.asarray(logits), jnp.asarray(draft))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module", params=["qwen1.5-0.5b", "qwen3-8b"])
def bridged_pair(request):
    """The gained cloud and its distilled draft, as (reference side, port
    side) tuples of (edge cfg, edge params, cloud cfg, cloud params)."""
    ref_cloud = ref_get_config(request.param).reduced()
    ref_edge = ref_get_config(request.param).edge_variant()
    cloud = perturbed(jax.tree.map(np.asarray, JM.init_params(
        ref_cloud, jax.random.PRNGKey(0))), 1)
    for block in cloud["layers"].values():
        for name in ("wq", "wk", "wv", "wo", "wi", "wg"):
            if name in block:
                block[name] = block[name] * np.float32(GAIN)
    rng = np.random.default_rng(2)
    draft = {**cloud, "layers": jax.tree.map(
        lambda a: (a + DRAFT_NOISE * a.std() * rng.standard_normal(a.shape)
                   ).astype(np.float32) if a.ndim >= 3 else a,
        cloud["layers"])}
    ref = (ref_edge, jax.tree.map(jnp.asarray, draft), ref_cloud,
           jax.tree.map(jnp.asarray, cloud))
    return ref, (port_cfg(ref_edge), params_from_numpy(port_cfg(ref_edge),
                                                       draft),
                 port_cfg(ref_cloud), params_from_numpy(port_cfg(ref_cloud),
                                                        cloud))


def _reference_loop(edge_cfg, edge, cloud_cfg, cloud, prompt, *, steps,
                    k, repaired=True):
    """The reference's ``speculative_generate`` loop from its own parts
    (``prefill``, ``decode_step`` jitted, ``greedy``, ``verify_prefix``);
    ``repaired``: a round whose proposals all match appends no cloud
    token (the reference appends the last draft token again).  Returns
    ((1, steps + 1) tokens, (proposed, accepted, cloud steps, cloud
    tokens))."""
    cache_len = prompt.shape[1] + steps + k + 2
    e_dec = jax.jit(lambda p, c, t: JT.decode_step(edge_cfg, p, c, t))
    c_dec = jax.jit(lambda p, c, t: JT.decode_step(cloud_cfg, p, c, t))
    _, e_cache = JT.prefill(edge_cfg, edge, prompt, cache_len=cache_len)
    c_logits, c_cache = JT.prefill(cloud_cfg, cloud, prompt,
                                   cache_len=cache_len)
    out = [JSP.greedy(c_logits)]
    counts = [0, 0, 0, 0]
    while len(out) < steps + 1:
        kk = min(k, steps + 1 - len(out))
        toks, tok = [], out[-1]
        for _ in range(kk):                     # draft_tokens, jitted
            lg, e_cache = e_dec(edge, e_cache, tok)
            tok = JSP.greedy(lg)
            toks.append(tok)
        draft = jnp.stack(toks, axis=1)
        seq = jnp.concatenate([out[-1][:, None], draft[:, :-1]], axis=1)
        logits = []
        for i in range(kk):
            lg, c_cache = c_dec(cloud, c_cache, seq[:, i])
            logits.append(lg)
        n_acc, next_tok = JSP.verify_prefix(jnp.stack(logits, axis=1), draft)
        n = int(n_acc[0])
        out.extend(draft[:, i] for i in range(n))
        appended = (n < kk or not repaired) and len(out) < steps + 1
        if appended:
            out.append(next_tok)
        for i, add in enumerate((kk, n, 1, int(appended))):
            counts[i] += add
        full = jnp.concatenate([prompt] + [t[:, None] for t in out], axis=1)
        _, e_cache = JT.prefill(edge_cfg, edge, full[:, :-1],
                                cache_len=cache_len)
        _, c_cache = JT.prefill(cloud_cfg, cloud, full[:, :-1],
                                cache_len=cache_len)
    return jnp.stack(out[:steps + 1], axis=1), tuple(counts)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_speculative_matches_reference(bridged_pair, k):
    (ref_edge, je, ref_cloud, jc), (edge_cfg, te, cloud_cfg, tc) = \
        bridged_pair
    prompt = tokens(5 + k, (1, 10), cloud_cfg.vocab_size)
    want, want_stats = _reference_loop(ref_edge, je, ref_cloud, jc,
                                       jnp.asarray(prompt), steps=STEPS, k=k)
    got, stats = SP.speculative_generate(edge_cfg, te, cloud_cfg, tc,
                                         as_long(prompt), steps=STEPS, k=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (stats.proposed, stats.accepted, stats.cloud_steps,
            stats.cloud_tokens) == want_stats
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JSP.cloud_greedy_generate(ref_cloud, jc, jnp.asarray(prompt), STEPS)))
    assert len(set(got[0].tolist())) > 1       # the stream is not one token


def test_reference_repeats_a_token_after_a_fully_accepted_round(
        bridged_pair):
    """The reference fault the port repairs: the scaled cloud drafting for
    itself accepts all of its first round's k proposals, and the
    reference's stream then holds the k-th twice where cloud-greedy
    decoding moves on; its own loop rebuilt unrepaired gives the same
    stream.  The port's equals cloud-greedy decoding.  (The prompt is one
    whose greedy stream does not repeat its k-th token, which would hide
    the fault.)"""
    (_, _, ref_cloud, jc), (_, _, cloud_cfg, tc) = bridged_pair
    k = 4
    prompt = tokens(25, (1, 10), cloud_cfg.vocab_size)
    greedy = np.asarray(JSP.cloud_greedy_generate(
        ref_cloud, jc, jnp.asarray(prompt), STEPS))
    ref, ref_stats = JSP.speculative_generate(
        ref_cloud, jc, ref_cloud, jc, jnp.asarray(prompt), steps=STEPS, k=k)
    ref = np.asarray(ref)
    rebuilt, _ = _reference_loop(ref_cloud, jc, ref_cloud, jc,
                                 jnp.asarray(prompt), steps=STEPS, k=k,
                                 repaired=False)
    np.testing.assert_array_equal(ref, np.asarray(rebuilt))
    assert ref_stats.acceptance_rate == 1.0
    assert ref[0, k + 1] == ref[0, k] != greedy[0, k + 1]
    np.testing.assert_array_equal(ref[0, :k + 1], greedy[0, :k + 1])
    got, stats = SP.speculative_generate(cloud_cfg, tc, cloud_cfg, tc,
                                         as_long(prompt), steps=STEPS, k=k)
    np.testing.assert_array_equal(got.numpy(), greedy)
    assert stats.acceptance_rate == 1.0 and stats.cloud_tokens == 0


def test_speculative_refuses_a_batch_or_another_vocabulary(pair):
    edge_cfg, edge, cloud_cfg, cloud = pair
    two = as_long(tokens(6, (2, 8), cloud_cfg.vocab_size))
    with pytest.raises(ValueError, match="one sequence"):
        SP.speculative_generate(edge_cfg, edge, cloud_cfg, cloud, two,
                                steps=2)
    full = get_config("qwen1.5-0.5b")
    with pytest.raises(ValueError, match="vocabulary"):
        SP.speculative_generate(edge_cfg, edge, full, cloud, two[:1],
                                steps=2)


def test_speculative_serving_runs_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.speculative_serving", "--steps",
         "8", "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "output identical to cloud-greedy: True" in out.stdout
    assert "device=cpu" in out.stdout


def test_speculative_serving_defaults_to_the_card(monkeypatch):
    from repro_torch import speculative_serving
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        speculative_serving.main([])
