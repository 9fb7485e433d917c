"""The port's scored workload, cascade and ``CloudEdgeSim`` against the
reference's, on the CPU, and the three entry points of the training
slice.

``build_workload`` draws from one numpy generator in the reference's
order, so every item's integer fields (arrival time, camera, edge,
ground truth) must equal the reference's whatever the weights.  The two
sides' inits differ (a torch generator against a JAX PRNG key); with the
reference's init carried across (the workload module's ``init_params``
replaced) the confidences agree within ``CONF_ATOL`` = 1e-4 after 10
AdamW steps (2.3e-6 measured here; see ``tests/test_torch_training.py``
for why trained parameters are not held tighter).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cascade as RC
from repro.models import meta as RM
from repro.serving import simulator as RSIM
from repro.serving import workload as RW
from repro_torch import bridge
from repro_torch import finetune_cq, quickstart, serve_cascade
from repro_torch.core import cascade as C
from repro_torch.models import transformer as T
from repro_torch.serving import simulator as SIM
from repro_torch.serving import workload as W
from repro_torch.serving.simulator import CloudEdgeSim, Item, LinkSpec, NodeSpec

CONF_ATOL = 1e-4
#: the workload the parity cases build on both sides (tier-1 size)
SMALL = dict(num_cameras=4, num_edges=2, duration_s=40.0, finetune_steps=10,
             seed=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for this file: a training step is hundreds of
    small operations, and where the test workers oversubscribe the host's
    cores each one stalls in torch's thread pool (the file took ~18 min
    under six workers, ~45 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(items):
    return [(i.t_arrival, i.camera, i.edge_device, i.is_query, i.nbytes,
             i.query) for i in items]


@pytest.fixture(scope="module")
def ref_wl():
    return RW.build_workload(**SMALL)


@pytest.fixture(scope="module")
def bridged_init(ref_wl):
    """The reference's init of ``SMALL`` (``PRNGKey(seed)``), as the
    port's parameters."""
    ref = RM.init_params(ref_wl.edge_cfg, jax.random.PRNGKey(SMALL["seed"]))
    return bridge.cq_params_from_numpy(jax.tree.map(np.asarray, ref))


def test_binary_batches_match_reference():
    profile = np.random.default_rng(0).dirichlet(np.ones(12))
    r_rng, p_rng = np.random.default_rng(5), np.random.default_rng(5)
    cfg = W.cq_config()
    ref = RW._binary_batches(r_rng, cfg, profile, None, 3, batch=32)
    port = W._binary_batches(p_rng, cfg, profile, None, 3, batch=32)
    for _ in range(3):
        (rt, rl), (pt, pl) = next(ref), next(port)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    assert r_rng.random() == p_rng.random()


def test_workload_integer_fields_match_reference(ref_wl):
    wl = W.build_workload(**SMALL, device="cpu")
    assert len(wl.items) == len(ref_wl.items) > 30
    assert _fields(wl.items) == _fields(ref_wl.items)
    np.testing.assert_array_equal(wl.clusters, np.asarray(ref_wl.clusters))
    assert wl.edge_cfg == W.cq_config()
    assert set(wl.timings) == {"finetune_s", "stream_s", "score_s"}
    assert len(wl.step_seconds) == SMALL["finetune_steps"]
    assert 0.0 <= wl.edge_accuracy <= 1.0


def test_workload_conf_matches_reference_with_bridged_init(
        ref_wl, bridged_init, monkeypatch):
    monkeypatch.setattr(W, "init_params", lambda cfg, gen: bridged_init)
    wl = W.build_workload(**SMALL, device="cpu")
    assert _fields(wl.items) == _fields(ref_wl.items)
    gap = max(abs(a.conf - b.conf) for a, b in zip(wl.items, ref_wl.items))
    assert gap <= CONF_ATOL, gap
    assert abs(wl.edge_accuracy - ref_wl.edge_accuracy) <= 1 / 256


def test_workload_confidences_informative():
    wl = W.build_workload(num_cameras=4, num_edges=2, duration_s=40.0,
                          finetune_steps=40, seed=3, device="cpu")
    conf = np.asarray([i.conf for i in wl.items])
    truth = np.asarray([i.is_query for i in wl.items])
    assert len(wl.items) > 30
    assert truth.any() and (~truth).any()
    # trained edge model separates query/non-query on average
    assert conf[truth].mean() > conf[~truth].mean() + 0.1
    assert set(np.unique([i.edge_device for i in wl.items])) <= {1, 2}


# --- cascade ------------------------------------------------------------------

def test_cascade_batch_routes_and_combines():
    conf = torch.tensor([0.95, 0.5, 0.02, 0.6])
    items = torch.arange(4)

    def cloud_fn(x):                      # item 1 and 3 escalate
        return torch.where(x % 2 == 1, 0.9, 0.1)

    out = C.cascade_batch(conf, cloud_fn, items, alpha=0.8, beta=0.1,
                          capacity=4)
    assert int(out["n_escalated"]) == 2
    dec = out["decision"].numpy()
    assert dec[0]                  # edge accept
    assert not dec[2]              # edge reject
    assert dec[1] and dec[3]       # cloud accepted both escalations


def test_compact_escalated_overflow_is_bounded():
    routes = torch.full((16,), C.ESCALATE, dtype=torch.int32)
    idx, valid, n = C.compact_escalated(routes, capacity=4)
    assert int(n) == 16
    assert int(valid.sum()) == 4
    np.testing.assert_array_equal(idx.numpy(), [0, 1, 2, 3])


def _cloud_votes(x):
    """A cloud model over integer payloads: query iff the payload is
    divisible by 3."""
    return (x % 3 == 0) * 0.8 + 0.1


@pytest.mark.parametrize("seed,b,capacity", [(0, 16, 16), (1, 64, 8),
                                             (2, 33, 40), (3, 128, 128),
                                             (4, 1, 1), (5, 200, 3)])
def test_cascade_batch_matches_reference(seed, b, capacity):
    """Routes, counts and decisions against the reference's, and the
    decisions against the cascade's definition.  One reference fault is
    left out of the comparison, and pinned by the next test: where item 0
    escalates and the buffer has a free slot, the reference's padded
    slots (which hold index 0) scatter item 0's edge decision over its
    cloud decision."""
    conf = np.random.default_rng(seed).random(b).astype(np.float32)
    payload = np.arange(b, dtype=np.int32)
    ref = RC.cascade_batch(jnp.asarray(conf), _cloud_votes,
                           jnp.asarray(payload), alpha=jnp.float32(0.7),
                           beta=jnp.float32(0.3), capacity=capacity)
    got = C.cascade_batch(torch.from_numpy(conf), _cloud_votes,
                          torch.from_numpy(payload), alpha=0.7, beta=0.3,
                          capacity=capacity)
    np.testing.assert_array_equal(got["routes"].numpy(),
                                  np.asarray(ref["routes"]))
    assert int(got["n_escalated"]) == int(ref["n_escalated"])
    assert float(got["escalated_frac"]) == float(ref["escalated_frac"])
    esc = np.flatnonzero((conf >= 0.3) & (conf <= 0.7))
    want = conf > 0.7
    want[esc[:capacity]] = payload[esc[:capacity]] % 3 == 0
    dec = got["decision"].numpy()
    np.testing.assert_array_equal(dec, want)
    ref_dec = np.asarray(ref["decision"])
    fault = len(esc) > 0 and esc[0] == 0 and len(esc) < capacity
    np.testing.assert_array_equal(dec[1:] if fault else dec,
                                  ref_dec[1:] if fault else ref_dec)


def test_cascade_batch_keeps_item_zero_cloud_decision():
    conf = torch.tensor([0.5, 0.9, 0.02, 0.6])
    out = C.cascade_batch(conf, _cloud_votes, torch.arange(4), alpha=0.8,
                          beta=0.1, capacity=4)
    assert out["decision"].tolist() == [True, True, False, True]
    ref = RC.cascade_batch(jnp.asarray(conf.numpy()), _cloud_votes,
                           jnp.arange(4), alpha=jnp.float32(0.8),
                           beta=jnp.float32(0.1), capacity=4)
    # the reference loses item 0's cloud decision (ROADMAP queue 3)
    assert np.asarray(ref["decision"]).tolist() == [False, True, False, True]


def test_cascade_pair_matches_reference(ref_wl, bridged_init):
    cfg = ref_wl.edge_cfg
    ref_p = RM.init_params(cfg, jax.random.PRNGKey(SMALL["seed"]))
    from repro.models import transformer as RT

    def ref_apply(p, toks):
        return RT.classify(cfg, p, RT.forward(cfg, p, toks, remat=False)[0])

    def port_apply(p, toks):
        return T.classify(cfg, p, T.forward(cfg, p, toks)[0])

    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (24, 16),
                                               dtype=np.int32)
    ref = RC.CascadePair(cfg, cfg, ref_apply, ref_apply)
    port = C.CascadePair(W.cq_config(), W.cq_config(), port_apply,
                         port_apply)
    with torch.no_grad():
        for side in ("edge_confidence", "cloud_confidence"):
            got = getattr(port, side)(bridged_init, torch.from_numpy(tokens))
            want = getattr(ref, side)(ref_p, jnp.asarray(tokens))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)


# --- CloudEdgeSim ---------------------------------------------------------------

def _items(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return [Item(t_arrival=float(t), camera=int(t) % 4,
                edge_device=int(t) % 2 + 1,
                conf=float(rng.uniform()), is_query=bool(rng.random() < 0.2))
            for t in np.sort(rng.uniform(0, 30, n))]


@pytest.mark.parametrize("scheme", ["surveiledge", "surveiledge_fixed",
                                    "edge_only", "cloud_only"])
def test_simulator_conservation(scheme):
    items = _items()
    sim = CloudEdgeSim([NodeSpec(1, 0.2), NodeSpec(2, 0.2)], NodeSpec(0, 0.05),
                       LinkSpec(uplink_MBps=1.0), scheme=scheme, seed=0)
    r = sim.run(items)
    assert len(r.latencies) == len(items)            # every item answered once
    assert np.all(r.latencies > 0)
    if scheme == "edge_only":
        assert r.uploaded_bytes == 0
    if scheme == "cloud_only":
        assert r.uploaded_bytes == sum(i.nbytes for i in items)
        assert np.array_equal(r.decisions, r.truths)  # cloud == ground truth


@pytest.mark.parametrize("scheme", ["surveiledge", "surveiledge_fixed",
                                    "edge_only", "cloud_only"])
def test_simulator_matches_reference(scheme, ref_wl):
    """The same items through both simulators: identical results."""
    def run(mod):
        items = [mod.Item(**dataclasses.asdict(i)) for i in ref_wl.items]
        sim = mod.CloudEdgeSim([mod.NodeSpec(1, 0.3), mod.NodeSpec(2, 0.3)],
                               mod.NodeSpec(0, 0.05),
                               mod.LinkSpec(uplink_MBps=0.5, rtt_s=0.1),
                               scheme=scheme, seed=1,
                               fixed_thresholds=(0.7, 0.2))
        return sim.run(items)

    ref, got = run(RSIM), run(SIM)
    assert got.summary() == ref.summary()
    np.testing.assert_array_equal(got.latencies, ref.latencies)
    assert got.trace == ref.trace and got.per_node_busy == ref.per_node_busy


def test_simulator_latency_grows_with_load():
    fast = [Item(i.t_arrival, i.camera, 1, i.conf, i.is_query)
            for i in _items(30, seed=1)]
    slow_edges = [NodeSpec(1, 2.0)]
    sim = CloudEdgeSim(slow_edges, NodeSpec(0, 0.05), LinkSpec(),
                       scheme="edge_only", seed=0)
    r_slow = sim.run(fast)
    sim2 = CloudEdgeSim([NodeSpec(1, 0.05)], NodeSpec(0, 0.05), LinkSpec(),
                        scheme="edge_only", seed=0)
    r_fast = sim2.run(fast)
    assert r_slow.avg_latency > r_fast.avg_latency


def test_wan_uplink_serializes():
    """Uploads must queue on the shared link: cloud-only latency grows with
    item size under a thin uplink."""
    items = _items(40, seed=2)

    def run(nbytes):
        its = [Item(i.t_arrival, i.camera, i.edge_device, i.conf,
                    i.is_query, nbytes=nbytes) for i in items]
        sim = CloudEdgeSim([NodeSpec(1, 0.1)], NodeSpec(0, 0.05),
                           LinkSpec(uplink_MBps=0.2), scheme="cloud_only",
                           seed=0)
        return sim.run(its).avg_latency
    assert run(400_000) > run(4_000) * 2


# --- entry points -------------------------------------------------------------

@pytest.mark.parametrize("entry,argv,expect", [
    (finetune_cq, ["--steps", "3"], "head-only probe"),
    (quickstart, [], "escalated"),
    (serve_cascade, ["--duration", "8", "--cameras", "3", "--edges", "2"],
     "cloud_only"),
])
def test_entry_points_run_on_the_cpu(entry, argv, expect, capsys,
                                    monkeypatch):
    # serve_cascade fine-tunes the reference example's 60 steps: 5 here
    monkeypatch.setattr(serve_cascade, "build_workload", functools.partial(
        W.build_workload, finetune_steps=5))
    entry.main(argv + ["--device", "cpu"])
    assert expect in capsys.readouterr().out
