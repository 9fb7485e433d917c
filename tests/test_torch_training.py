"""The port's cloud-side training against the reference's, on the CPU:
clustering, camera profiles, AdamW and its schedules, the classifier loss
and its gradients, the fine-tune loop and the Fig. 5 schemes.

The reference draws its CQ weights from a JAX PRNG key, so every parity
case starts both sides from the reference's weights carried across
through numpy (``bridge.cq_params_from_numpy``) and from zero optimizer
state.  Tolerances, each measured on this CPU with the test's inputs:
- ``kmeans``: assignments exact, centers and inertia within 1e-6;
  ``proportion_vector`` exact;
- ``classifier_loss`` within ``LOSS_ATOL`` = 1e-6, each gradient leaf
  within ``GRAD_RTOL`` = 1e-4 of that leaf's largest magnitude;
- one ``adamw.apply`` within 1e-6 (both sides f32, the same operations);
- a fine-tune's loss at steps 1-5 within ``TRAJ_ATOL`` = 1e-5 (7.2e-7 at
  worst over three seeds).  Parameters are not held after several
  steps: Adam's first step is about lr * sign(g), so an entry whose
  gradient cancels to a few ulps can move by 2 lr on one side only
  (1.4e-4 after one step at these inputs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import clustering as RCL
from repro.core import finetune as RFT
from repro.core import profiles as RPR
from repro.models import meta as RM
from repro.optim import adamw as RA
from repro.optim import schedules as RS
from repro.serving.workload import _binary_batches as ref_batches
from repro_torch import bridge
from repro_torch.core import clustering as CL
from repro_torch.core import finetune as FT
from repro_torch.core import profiles as PR
from repro_torch.data import synthetic_video as SV
from repro_torch.models import meta as M
from repro_torch.optim import adamw as A
from repro_torch.optim import schedules as S
from repro_torch.serving.workload import _binary_batches
from repro_torch.system.pixel_frontend import cq_config

LOSS_ATOL = 1e-6
GRAD_RTOL = 1e-4
ADAM_ATOL = 1e-6
TRAJ_ATOL = 1e-5
UNIFORM = np.ones(SV.NUM_CLASSES) / SV.NUM_CLASSES


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


@pytest.fixture(scope="module")
def cfgs():
    full = ref_get_config("surveiledge-cls")
    ref_cfg = dataclasses.replace(full.edge_variant(), num_query_classes=2,
                                  vocab_size=full.vocab_size)
    return ref_cfg, cq_config()


@pytest.fixture(scope="module")
def weights(cfgs):
    """The reference's init (PRNGKey(5)) on both sides."""
    ref = RM.init_params(cfgs[0], jax.random.PRNGKey(5))
    return ref, bridge.cq_params_from_numpy(jax.tree.map(np.asarray, ref))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _leaf_pairs(ref_tree, port_tree):
    ref = dict(M.leaves(jax.tree.map(np.asarray, ref_tree)))
    port = dict(M.leaves(port_tree))
    assert set(ref) == set(port)
    return [(path, ref[path], _np(port[path])) for path in sorted(ref)]


# --- clustering -------------------------------------------------------------

def _profile_sets():
    """(name, (N, C) f32 profiles, k) cases: Dirichlet mixes, a fleet's
    own profiles, and two distinct rows under k = 3 (a duplicated
    center: first-index ties and an empty cluster kept in place)."""
    out = []
    for seed, (n, c, k) in enumerate([(8, 12, 2), (20, 4, 3), (37, 12, 5),
                                      (64, 12, 4), (5, 3, 5)]):
        rng = np.random.default_rng(seed)
        out.append((f"dirichlet{seed}",
                    rng.dirichlet(np.full(c, 0.7), size=n).astype(np.float32),
                    k))
    cams = SV.make_cameras(12, seed=3)
    rng = np.random.default_rng(3)
    _, profs = RPR.build_profiles(
        {c.cam_id: rng.choice(SV.NUM_CLASSES, size=400, p=c.class_mix)
         for c in cams}, SV.NUM_CLASSES)
    out.append(("fleet", profs.astype(np.float32), 3))
    two = np.repeat(np.eye(4, dtype=np.float32)[:2], 3, axis=0)
    out.append(("two_rows", two, 3))
    return out


@pytest.mark.parametrize("name,profs,k", _profile_sets(),
                         ids=[c[0] for c in _profile_sets()])
def test_kmeans_matches_reference(name, profs, k):
    ra, rc, ri = RCL.kmeans(jnp.asarray(profs), k)
    pa, pc, pi = CL.kmeans(torch.from_numpy(profs), k)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=0, atol=1e-6)
    assert abs(float(pi) - float(ri)) <= 1e-6


@pytest.mark.parametrize("n,c", [(0, 4), (1, 4), (400, 12), (1000, 7)])
def test_proportion_vector_matches_reference(n, c):
    labels = np.random.default_rng(n).integers(0, c, size=n).astype(np.int32)
    want = np.asarray(RCL.proportion_vector(jnp.asarray(labels), c))
    got = CL.proportion_vector(torch.from_numpy(labels), c).numpy()
    np.testing.assert_array_equal(got, want)


def test_kmeans_separates_two_scene_types():
    rng = np.random.default_rng(4)
    road = rng.dirichlet([8, 1, 1, 1], size=10)
    plaza = rng.dirichlet([1, 8, 1, 1], size=10)
    profs = torch.from_numpy(np.concatenate([road, plaza]))
    assign, centers, inertia = CL.kmeans(profs, 2)
    a = assign.numpy()
    assert len(set(a[:10])) == 1 and len(set(a[10:])) == 1
    assert a[0] != a[10]
    assert float(inertia) < 1.0


def test_proportion_vector_normalized():
    labels = torch.tensor([0, 0, 1, 2, 2, 2], dtype=torch.int32)
    pv = CL.proportion_vector(labels, 4)
    np.testing.assert_allclose(pv.numpy(), [2 / 6, 1 / 6, 3 / 6, 0],
                               atol=1e-6)


def test_profiles_and_training_set_match_reference():
    cams = SV.make_cameras(8, seed=0)
    rng = np.random.default_rng(0)
    leisure = {c.cam_id: rng.choice(SV.NUM_CLASSES, size=400, p=c.class_mix)
               for c in cams}
    r_ids, r_profs = RPR.build_profiles(leisure, SV.NUM_CLASSES)
    p_ids, p_profs = PR.build_profiles(leisure, SV.NUM_CLASSES)
    assert p_ids == r_ids
    np.testing.assert_array_equal(p_profs, r_profs)
    r_assign, r_centers = RPR.cluster_cameras(r_profs, k=2)
    p_assign, p_centers = PR.cluster_cameras(p_profs, k=2)
    np.testing.assert_array_equal(p_assign, r_assign)
    np.testing.assert_allclose(p_centers, r_centers, rtol=0, atol=1e-6)
    pool = np.random.default_rng(1).choice(SV.NUM_CLASSES, size=2000)
    picks = [f.select_training_set(pool, r_centers[0], SV.QUERY_CLASS, 200,
                                   400, np.random.default_rng(2))
             for f in (RPR, PR)]
    np.testing.assert_array_equal(picks[1], picks[0])
    with pytest.raises(ValueError, match="absent"):
        PR.select_training_set(np.zeros(10, int), r_centers[0], 3, 2, 2,
                               np.random.default_rng(0))


# --- loss, gradients, optimizer ---------------------------------------------

def test_classifier_loss_and_grads_match_reference(cfgs, weights):
    ref_cfg, cfg = cfgs
    ref_p, port_p = weights
    tokens, labels = next(ref_batches(np.random.default_rng(7), ref_cfg,
                                      UNIFORM, None, SV.QUERY_CLASS))
    r_loss, r_grads = jax.value_and_grad(
        lambda p: RFT.classifier_loss(ref_cfg, p, tokens, labels))(ref_p)
    live = M.tree_map(lambda t: t.clone().requires_grad_(True), port_p)
    p_loss = FT.classifier_loss(cfg, live, torch.from_numpy(
        np.array(tokens)), torch.from_numpy(np.array(labels)))
    p_loss.backward()
    assert abs(float(p_loss.detach()) - float(r_loss)) <= LOSS_ATOL
    grads = M.tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                       else t.grad, live)
    for path, want, got in _leaf_pairs(r_grads, grads):
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_RTOL * scale, (path, err, scale)
    ev = next(ref_batches(np.random.default_rng(8), ref_cfg, UNIFORM, None,
                          SV.QUERY_CLASS, batch=256))
    assert FT.accuracy_of(cfg, port_p, *(torch.from_numpy(np.array(a))
                                         for a in ev)) == \
        RFT.accuracy_of(ref_cfg, ref_p, *ev)


@pytest.mark.parametrize("case", ["unclipped", "clipped", "scheduled"])
def test_adamw_apply_matches_reference(cfgs, weights, case):
    """Two consecutive applies (counts 1 and 2) on identical numpy
    gradients, state and parameters."""
    ref_p, port_p = weights
    rng = np.random.default_rng(11)
    shapes = {p: np.shape(a) for p, a, _ in _leaf_pairs(ref_p, port_p)}
    # global norms ~1e-2 (no clipping) or ~1e3 (clipped to 1)
    mag = 1e3 if case == "clipped" else 1e-2
    total = sum(int(np.prod(s)) for s in shapes.values())
    grads_np = [{p: (rng.standard_normal(s) * mag / np.sqrt(total)
                     ).astype(np.float32) for p, s in shapes.items()}
                for _ in range(2)]
    sched = (3, 10) if case == "scheduled" else None
    rcfg = RA.AdamWConfig(lr=1e-3, weight_decay=0.01, clip_norm=1.0,
                          schedule=sched and RS.cosine_with_warmup(*sched))
    pcfg = A.AdamWConfig(lr=1e-3, weight_decay=0.01, clip_norm=1.0,
                         schedule=sched and S.cosine_with_warmup(*sched))

    def nest(flat, wrap):
        out = {}
        for path, a in flat.items():
            node = out
            *head, last = path.split("/")
            for key in head:
                node = node.setdefault(key, {})
            node[last] = wrap(a)
        return out

    r_state, p_state = RA.init(ref_p), A.init(port_p)
    r_par, p_par = ref_p, port_p
    for g in grads_np:
        r_par, r_state, r_m = RA.apply(rcfg, nest(g, jnp.asarray), r_state,
                                       r_par)
        p_par, p_state, p_m = A.apply(pcfg, nest(g, torch.from_numpy),
                                      p_state, p_par)
        assert abs(float(p_m["grad_norm"]) - float(r_m["grad_norm"])) <= \
            1e-6 * float(r_m["grad_norm"])
        assert abs(float(p_m["lr"]) - float(r_m["lr"])) <= 1e-12
        for tree_r, tree_p in ((r_par, p_par), (r_state.m, p_state.m),
                               (r_state.v, p_state.v)):
            for path, want, got in _leaf_pairs(tree_r, tree_p):
                np.testing.assert_allclose(got, want, rtol=0, atol=ADAM_ATOL,
                                           err_msg=path)
    assert int(p_state.count) == int(r_state.count) == 2
    if case == "clipped":
        assert float(r_m["grad_norm"]) > 100
    if case == "unclipped":
        assert float(r_m["grad_norm"]) < 1


def test_schedules_match_reference():
    for ref_s, port_s in ((RS.cosine_with_warmup(10, 100, floor=0.1),
                           S.cosine_with_warmup(10, 100, floor=0.1)),
                          (RS.linear_warmup(7), S.linear_warmup(7))):
        for s in range(0, 120, 3):
            want = float(ref_s(jnp.asarray(s)))
            got = float(port_s(torch.tensor(s)))
            assert abs(got - want) <= 1e-7, (s, got, want)


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}
    cfg = A.AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=100.0)
    state = A.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    for _ in range(200):
        live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss(live).backward()
        g = {k: v.grad for k, v in live.items()}
        params, state, _ = A.apply(cfg, g, state, params)
    assert float(loss(params)) < 1e-3


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    cfg = A.AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    state = A.init(params)
    g = {"w": torch.full((4,), 1e6)}
    new, state, metrics = A.apply(cfg, g, state, params)
    assert float(metrics["grad_norm"]) > 1e5
    assert float(torch.max(torch.abs(new["w"]))) < 2.0   # clipped step


def test_weight_decay_only_on_matrices():
    params = {"w": torch.ones((2, 2)), "b": torch.ones(2)}
    cfg = A.AdamWConfig(lr=0.1, weight_decay=0.5, clip_norm=100.0)
    state = A.init(params)
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _, _ = A.apply(cfg, zero_g, state, params)
    assert float(torch.max(torch.abs(new["w"]))) < 1.0   # decayed
    np.testing.assert_allclose(new["b"].numpy(), 1.0)    # not decayed


def test_cosine_schedule_shape():
    sched = S.cosine_with_warmup(10, 100, floor=0.1)
    vals = [float(sched(torch.tensor(s))) for s in range(0, 101, 10)]
    assert vals[0] == 0.0
    assert abs(vals[1] - 1.0) < 1e-6        # end of warmup
    assert vals[-1] <= vals[1]
    assert min(vals[1:]) >= 0.1 - 1e-6


# --- the fine-tune loop -------------------------------------------------------

@pytest.fixture(scope="module")
def port_5_steps(cfgs, weights):
    """The port's 5-step fine-tune from the bridged weights."""
    return FT.finetune(cfgs[1], weights[1], _binary_batches(
        np.random.default_rng(0), cfgs[1], UNIFORM, None, SV.QUERY_CLASS),
        steps=5)


@pytest.mark.parametrize("steps", [1, 2, 3, 4, 5])
def test_finetune_loss_trajectory_matches_reference(cfgs, weights,
                                                    port_5_steps, steps):
    """The port's loss at step ``steps`` against the reference's (the
    final loss of a ``steps``-step run: the reference keeps no others)."""
    ref_cfg, _ = cfgs
    ref = RFT.finetune(ref_cfg, weights[0], ref_batches(
        np.random.default_rng(0), ref_cfg, UNIFORM, None, SV.QUERY_CLASS),
        steps=steps)
    port = port_5_steps
    assert ref.steps == steps and port.steps == 5
    assert abs(port.step_losses[steps - 1] - ref.final_loss) <= TRAJ_ATOL
    assert len(port.step_seconds) == len(port.step_losses) == 5
    assert port.step_losses[-1] == port.final_loss
    assert port.train_seconds >= sum(port.step_seconds) > 0


def test_finetune_takes_exactly_steps_batches(cfgs, weights):
    """The shared generator's state after training decides the stream."""
    _, cfg = cfgs
    rng, twin = np.random.default_rng(4), np.random.default_rng(4)
    FT.finetune(cfg, weights[1], _binary_batches(rng, cfg, UNIFORM, None,
                                                 SV.QUERY_CLASS), steps=3)
    it = _binary_batches(twin, cfg, UNIFORM, None, SV.QUERY_CLASS)
    for _ in range(3):
        next(it)
    assert rng.random() == twin.random()


def test_finetune_improves_over_init(cfgs):
    _, cfg = cfgs
    rng = np.random.default_rng(0)
    ev = next(_binary_batches(np.random.default_rng(9), cfg, UNIFORM, None,
                              SV.QUERY_CLASS, batch=256))
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    acc0 = FT.accuracy_of(cfg, params, *ev)
    res = FT.finetune(cfg, params,
                      _binary_batches(rng, cfg, UNIFORM, None,
                                      SV.QUERY_CLASS),
                      steps=50, lr=1e-3, eval_set=ev)
    assert res.accuracy > max(acc0, 0.65)
    assert res.train_seconds > 0


def test_head_only_touches_only_head(cfgs):
    _, cfg = cfgs
    rng = np.random.default_rng(1)
    params = M.init_params(cfg, torch.Generator().manual_seed(1))
    res = FT.finetune(cfg, params,
                      _binary_batches(rng, cfg, UNIFORM, None,
                                      SV.QUERY_CLASS),
                      steps=5, lr=1e-2, head_only=True)
    # every leaf outside the head bit-identical (its weight decay too)
    for path, old in M.leaves(params):
        new = dict(M.leaves(res.params))[path]
        if path.startswith("cls_head/"):
            continue
        assert torch.equal(old, new), path
    assert float(torch.max(torch.abs(params["cls_head"]["w"]
                                     - res.params["cls_head"]["w"]))) > 0


def test_fig5_schemes_step_counts(cfgs, monkeypatch):
    """The three schemes' dispatch at a small fleet: step counts
    (``FIG5_STEPS``, ``FIG5_STEPS`` a camera, 0) and ``pretrain_backbone``
    as the shared start.  The budget is cut to 4 steps here; the 40-step
    runs and their timing order (All-Fine-tune's summed time above
    SurveilEdge's, a wall-clock claim) are held on the card by
    ``chip_smoke.py``."""
    _, cfg = cfgs
    monkeypatch.setattr(FT, "FIG5_STEPS", 4)

    def pool():
        r = np.random.default_rng(1)
        while True:
            cls = r.integers(0, SV.NUM_CLASSES, size=64)
            tokens, labels = SV.labeled_crop_batch(cls, r, cfg.vocab_size)
            yield (torch.from_numpy(tokens), torch.from_numpy(
                (labels == SV.QUERY_CLASS).astype(np.int32)))

    pre = FT.pretrain_backbone(cfg, torch.Generator().manual_seed(0), pool(),
                               steps=3, device="cpu")
    ev = next(_binary_batches(np.random.default_rng(99), cfg, UNIFORM, None,
                              SV.QUERY_CLASS, batch=64))
    it_fn = lambda: _binary_batches(np.random.default_rng(2), cfg,  # noqa
                                    UNIFORM, None, SV.QUERY_CLASS, batch=16)
    cams = {c: (lambda c=c: _binary_batches(np.random.default_rng(10 + c),
                                            cfg, UNIFORM, None,
                                            SV.QUERY_CLASS, batch=16))
            for c in range(2)}
    out = {s: FT.run_scheme(s, cfg, pre, it_fn, cams, ev)
           for s in FT.FIG5_SCHEMES}
    assert [r.steps for r in out["surveiledge"].values()] == [FT.FIG5_STEPS]
    assert sorted(out["all_finetune"]) == [0, 1]
    assert all(r.steps == FT.FIG5_STEPS for r in out["all_finetune"].values())
    assert out["no_finetune"][-1].steps == 0
    assert out["no_finetune"][-1].train_seconds == 0.0
    for res in (*out["surveiledge"].values(), *out["no_finetune"].values()):
        assert 0.0 <= res.accuracy <= 1.0
    with pytest.raises(ValueError):
        FT.run_scheme("bogus", cfg, pre, it_fn, cams, ev)
