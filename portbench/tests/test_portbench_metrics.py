"""The metric readers: rates over the whole window and all its work,
tails over every request, a stall moves them, and a reader with nothing
to read gives nothing."""
import types

import pytest

import cases
from portbench import harness as H
from portbench import stats

MODEL = cases.config("qwen1.5-0.5b")["model"]
EDGE = cases.config("qwen1.5-0.5b")["edge"]


def _run(stall_s=0.0, stalled=3):
    """Two bursts of four requests (one edge-settled each), 10 ms a
    prefill, 5 ms a tick; request ``stalled`` of the second burst waits
    ``stall_s`` longer for its first token and its answer."""
    reqs, admits, steps, t = {}, [], [], 0.0
    for b in range(2):
        t_sub = t
        reqs[4 * b] = {"route": "edge_accept", "t_submit": t_sub,
                       "t_first": None, "t_done": t_sub + 0.001,
                       "output": [1]}
        for i in range(1, 4):
            rid = 4 * b + i
            extra = stall_s if (b == 1 and i == stalled) else 0.0
            t += 0.010 + extra
            admits.append((rid, t - 0.010 - extra, t, 100))
            reqs[rid] = {"route": "cloud", "t_submit": t_sub,
                         "t_first": t, "t_done": None, "output": [7] * 5}
        for k in range(5):
            steps.append((t, t + 0.005, 3, 4))
            t += 0.005
        for i in range(1, 4):
            reqs[4 * b + i]["t_done"] = t
    return types.SimpleNamespace(
        setup_s=1.0, window_s=t, requests=reqs, admits=admits, steps=steps,
        submits=[(r, v["t_submit"], v["t_submit"] + 0.001)
                 for r, v in reqs.items()], model=MODEL, trace=None)


def _read(name, run):
    return H.reader(name).read(run)


def test_rates_take_all_work_over_the_whole_window():
    run = _run()
    assert _read("tokens_per_s", run) == pytest.approx(6 * 5 / run.window_s)
    assert _read("prefill_tokens_per_s", run) == pytest.approx(100 / 0.010)
    assert _read("decode_tick_ms", run) == pytest.approx(5.0)
    assert _read("slot_use", run) == pytest.approx(75.0)
    assert _read("edge_ms", run) == pytest.approx(1.0)
    assert _read("setup_s", run) == 1.0


def test_tails_are_over_every_request():
    run = _run()
    ttft = sorted((r["t_first"] - r["t_submit"]) * 1e3
                  for r in run.requests.values() if r["route"] == "cloud")
    assert _read("ttft_p95_ms", run) == pytest.approx(
        stats.percentile(ttft, 95))
    assert len(ttft) == 6
    answer = [(r["t_done"] - r["t_submit"]) * 1e3
              for r in run.requests.values()]
    assert _read("answer_p95_ms", run) == pytest.approx(
        stats.percentile(answer, 95))


@pytest.mark.parametrize("name", ["tokens_per_s", "ttft_p95_ms",
                                  "answer_p95_ms", "prefill_tokens_per_s"])
def test_a_stall_moves_the_metric(name):
    calm, stalled = _run(), _run(stall_s=0.5)
    better = {"tokens_per_s": "higher", "prefill_tokens_per_s": "higher"}
    a, b = _read(name, calm), _read(name, stalled)
    if better.get(name) == "higher":
        assert b < 0.9 * a
    else:
        assert b > a + 100


def test_an_unanswered_request_counts_as_the_whole_window():
    run = _run()
    answered = _read("answer_p95_ms", run)
    for r in run.requests.values():
        r["t_done"] = None
    assert _read("answer_p95_ms", run) == pytest.approx(run.window_s * 1e3)
    assert run.window_s * 1e3 > answered


@pytest.mark.parametrize("name", ["flash_roofline", "device_idle_share"])
def test_trace_readers_give_nothing_without_a_trace(name):
    assert _read(name, _run()) is None


def test_flash_roofline_reads_the_launches_of_the_slice():
    run = _run()
    L, Le = MODEL["num_layers"], EDGE["num_layers"]
    n = 2 * L + 3 * Le
    kernels = [("void (anonymous namespace)::tc::tc_kernel<64, 64, 2>(x)",
                0.001 * i, 0.0002) for i in range(n)]
    kernels.append(("void gemm_kernel(y)", 0.5, 0.1))
    run.edge = EDGE
    run.trace = {"admits": [256, 512], "submits": [256, 512, 300],
                 "kernels": kernels, "busy_s": 0.3, "window_s": 1.2}
    from portbench.roofline import KERNELS, bound_s

    def bound(m, S):
        return bound_s(*KERNELS["flash"](1, m["num_heads"],
                                         m["num_kv_heads"], S, S,
                                         m["head_dim"]))
    want = (L * sum(bound(MODEL, S) for S in (256, 512)) +
            Le * sum(bound(EDGE, S) for S in (256, 512, 300))) / (
        n * 0.0002)
    assert _read("flash_roofline", run) == pytest.approx(100 * want)
    assert _read("device_idle_share", run) == pytest.approx(75.0)
    run.trace["admits"] = [256]
    assert _read("flash_roofline", run) is None


def test_prefill_mfu_counts_active_experts_only():
    from portbench.flops import prefill_of
    g = cases.config("granite-moe-1b-a400m")["model"]
    dense = dict(g, num_experts=0)
    extra = prefill_of("moe")(g, 100) - (
        prefill_of("dense")(dict(dense, d_ff=0), 100))
    per_layer = 2.0 * 100 * g["d_model"] * g["num_experts"] + \
        g["top_k"] * 6.0 * 100 * g["d_model"] * g["d_ff"]
    assert extra == pytest.approx(g["num_layers"] * per_layer)


def test_a_family_without_a_count_reads_nothing():
    from portbench.flops import prefill_of
    assert prefill_of("no_such_family") is None
    run = _run()
    run.model = dict(MODEL, family="no_such_family")
    assert _read("prefill_mfu", run) is None


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert stats.union_s(iv) == 3.0
    assert stats.gaps_between(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile([], 95) is None
