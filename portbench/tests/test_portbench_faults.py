"""A whole run of the harness on the CPU at a small size, the look for a
card skipped: correct as the program stands, and not correct with the
timed path broken underneath in each way a one-card serving cell can
break, among them faults confined to one slot of the decode batch,
which the sample's request of every slot reads.  (Its cells run on one
card: there is no exchange between cards to leave out.)"""
import time

import pytest
import torch

import cases
from portbench import harness as H


def _run(name="qwen1.5-0.5b"):
    return H.measure(cases.bench(), cases.cell(name), 20240611, 0.2, False,
                     "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-moe-1b-a400m"])
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 8
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"tokens_per_s", "ttft_p95_ms",
                                   "answer_p95_ms", "setup_s"}
    assert out["checks"]["token_miss"][0] == 0


def _altered_token(monkeypatch):
    from repro_torch.serving import engine
    greedy = engine.greedy
    monkeypatch.setattr(engine, "greedy",
                        lambda logits: (greedy(logits) + 1) % 384)


def _state_unchanged(monkeypatch):
    from repro_torch.models import transformer as T
    step = T.decode_step

    def frozen(cfg, params, cache, token, **kw):
        saved = T.M.tree_map(lambda t: t.clone(), cache["layers"])
        logits, _ = step(cfg, params, cache, token, **kw)
        T.M.tree_map(lambda dst, src: dst.copy_(src), cache["layers"], saved)
        return logits, cache
    monkeypatch.setattr(T, "decode_step", frozen)


def _half_batch(monkeypatch):
    from repro_torch.models import transformer as T
    step = T.decode_step

    def half(cfg, params, cache, token, **kw):
        logits, new = step(cfg, params, cache, token, **kw)
        keep = torch.arange(logits.shape[0]) < logits.shape[0] // 2
        return torch.where(keep[:, None], logits, logits.mean(0)), new
    monkeypatch.setattr(T, "decode_step", half)


def _one_slot_token(monkeypatch):
    from repro_torch.serving import engine
    greedy = engine.greedy

    def one(logits):
        out = greedy(logits)
        if out.dim() == 1 and out.shape[0] > 1:
            out = out.clone()
            out[0] = (out[0] + 1) % logits.shape[-1]
        return out
    monkeypatch.setattr(engine, "greedy", one)


def _one_slot_cache(monkeypatch):
    from repro_torch.models import meta as M
    from repro_torch.serving.engine import DecodeEngine
    write = DecodeEngine._write_slot_cache

    def wrong(self, i, cache1):
        write(self, i, cache1)
        if i == 0:
            M.tree_map(lambda t: t[:, 0:1].mul_(-1.0), self.cache["layers"])
    monkeypatch.setattr(DecodeEngine, "_write_slot_cache", wrong)


def _edge_altered(monkeypatch):
    from repro_torch.core import cascade as C
    conf = C.confidence_from_logits
    monkeypatch.setattr(C, "confidence_from_logits",
                        lambda logits, q=1: conf(logits, q) * 0.999)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch, _one_slot_token,
                                   _one_slot_cache, _edge_altered])
@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-moe-1b-a400m"])
def test_a_broken_path_is_not_correct(fault, name, monkeypatch):
    fault(monkeypatch)
    out = _run(name)
    assert not out["correct"], out["checks"]
    bad = [k for k, (v, lim) in out["checks"].items() if not v <= lim]
    assert bad


@pytest.mark.parametrize("fault", [_one_slot_token, _one_slot_cache])
def test_a_fault_in_one_slot_among_many_is_read(fault, monkeypatch):
    """One slot of twelve wrong: under a tenth of the sampled tokens, so
    the mixture of experts' 90th percentile stays within its limit, but
    the sample holds a request of every slot, and each wrong token lies
    far below the reference's best."""
    fault(monkeypatch)
    cell = cases.cell("granite-moe-1b-a400m", slots=12, burst=24,
                      check_requests=14)
    out = H.measure(cases.bench(), cell, 20240611, 0.2, False, "cpu",
                    time.perf_counter())
    assert not out["correct"]
    p90, lim = out["checks"]["logit_err_p90"]
    assert p90 <= lim
    assert out["checks"]["token_miss"][0] > 0


@pytest.mark.parametrize("token_band,missed", [(1e-3, True), (1e9, False)])
def test_token_miss_counts_the_tokens_past_the_cells_band(token_band, missed,
                                                          monkeypatch):
    """One slot's tokens altered: each lies far below the reference's best,
    past a band of 1e-3 and inside one of 1e9 (the route's band around
    the thresholds is another)."""
    _one_slot_token(monkeypatch)
    cell = cases.cell("granite-moe-1b-a400m")
    cell.checks["token_band"] = token_band
    out = H.measure(cases.bench(), cell, 20240611, 0.2, False, "cpu",
                    time.perf_counter())
    assert (out["checks"]["token_miss"][0] > 0) == missed
