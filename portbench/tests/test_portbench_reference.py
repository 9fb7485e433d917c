"""The plain reference against the program on the CPU at a small size,
for both families, the mixture of experts' per-call capacity with it;
and the lower-precision control failing the check there."""
import numpy as np
import pytest
import torch

import cases
from portbench import harness as H
from portbench import weights
from portbench.reference import model as REF
from portbench.reference import moe as MOE

F32 = REF.Precision("f32")


def _engine_logits(cfg_dict, params, prompts, steps, monkeypatch):
    """Each prompt's served tokens and the logits that chose them, from
    the program's DecodeEngine (one slot each, decoded together)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.engine import DecodeEngine, Request
    cfg = ModelConfig(**cfg_dict)
    got = {"prefill": [], "decode": []}
    prefill, decode = T.prefill, T.decode_step

    def tap_prefill(*a, **kw):
        out = prefill(*a, **kw)
        got["prefill"].append(out[0][0].clone())
        return out

    def tap_decode(*a, **kw):
        out = decode(*a, **kw)
        got["decode"].append(out[0].clone())
        return out

    monkeypatch.setattr(T, "prefill", tap_prefill)
    monkeypatch.setattr(T, "decode_step", tap_decode)
    eng = DecodeEngine(cfg, params, slots=len(prompts),
                       cache_len=max(len(p) for p in prompts) + steps + 1,
                       device="cpu")
    for i, p in enumerate(prompts):
        assert eng.admit(Request(rid=i, tokens=p, max_new=steps + 1))
    out = {}
    for _ in range(steps):
        for rid, toks in eng.step():
            out[rid] = toks
    logits = [torch.stack([got["prefill"][i]] +
                          [d[i] for d in got["decode"]]) for i in
              range(len(prompts))]
    return out, logits


@pytest.mark.parametrize("name,cf", [("qwen1.5-0.5b", None),
                                     ("granite-moe-1b-a400m", 1.25),
                                     ("granite-moe-1b-a400m", 0.5)])
def test_reference_matches_prefill_and_decode(name, cf, monkeypatch):
    cfg = cases.config(name)
    m = cfg["model"]
    if cf is not None:
        m["capacity_factor"] = cf
    params = weights.make(m, cfg["init"], 7, "cloud", "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, size=n).astype(np.int32)
               for n in (40, 23, 57)]
    steps = 5
    served, logits = _engine_logits(m, params, prompts, steps, monkeypatch)
    dropped = 0
    for i, p in enumerate(prompts):
        toks = torch.as_tensor(np.asarray(served[i]))
        assert len(toks) == steps + 1
        ref, margin, d = REF.served_logits(m, params, torch.as_tensor(p),
                                           toks, F32)
        dropped += d
        assert torch.equal(torch.argmax(logits[i], -1).to(torch.int32),
                           toks.to(torch.int32))
        err = float((ref - logits[i]).abs().max())
        assert err < 2e-4, (i, err)
        assert float(REF.gaps(ref, toks).max()) < 2e-4
    if cf == 0.5:
        assert dropped > 0          # the capacity bites at the admission
    if cf == 1.25:
        assert MOE.capacity(m, 40) == 16 and MOE.capacity(m, 1) == 8


def test_edge_confidence_matches_the_servers():
    from repro_torch.core.thresholds import ThresholdState
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.engine import CascadeServer
    for name in ("qwen1.5-0.5b", "granite-moe-1b-a400m"):
        cfg = cases.config(name)
        e, m = cfg["edge"], cfg["model"]
        ew = weights.make(e, cfg["init"], 11, "edge", "cpu")
        srv = CascadeServer(ModelConfig(**e), ew, ModelConfig(**m),
                            weights.make(m, cfg["init"], 11, "cloud", "cpu"),
                            slots=2, cache_len=80, device="cpu",
                            thresholds=ThresholdState(alpha=0.9, beta=0.1))
        rng = np.random.default_rng(1)
        for n in (30, 64):
            toks = rng.integers(0, 256, size=n).astype(np.int32)
            got = srv.edge_conf(toks)
            want, _ = REF.edge_conf(e, ew, torch.as_tensor(toks), F32)
            assert abs(got - want) < 1e-6


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12,
                      -3.0 - 2**-10])
    got = REF._tf32(x)
    assert got.tolist() == [1.0, 1.0 + 4 * 2**-11, 1.0, -3.0]   # ties: even


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-moe-1b-a400m"])
def test_the_control_fails_the_check_and_the_program_passes(name):
    for seed in (1, 2, 3):
        cell = cases.cell(name)
        drv, st, w = H.window_only(cell, seed, torch.device("cpu"), 2)
        r = drv.check(w, st, cell, seed, torch.device("cpu"),
                      control="tf32")
        limits = cell.checks["limits"]
        assert all(r[k] <= lim for k, lim in limits.items()), r
        ctl = {k: r.get("control_" + k) for k in limits
               if "control_" + k in r}
        assert any(v > limits[k] for k, v in ctl.items()), ctl


def test_a_family_is_found_by_its_name():
    """Each family's layer is a file of its own, found by the model's
    ``family``; the weights are laid out as that file says."""
    from portbench.reference import dense
    for name, mod in (("qwen1.5-0.5b", dense), ("granite-moe-1b-a400m", MOE)):
        m = cases.config(name)["model"]
        assert REF.family(m) is mod
        paths = [path for path, *_ in weights.leaves(m)]
        assert [("layers",) + p for p, *_ in mod.layer_leaves(m)] == \
            paths[1:-3]
    with pytest.raises(ModuleNotFoundError):
        REF.family({"family": "no_such_family"})
