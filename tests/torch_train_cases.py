"""The LLM train step, port against reference, shared by the per-family
files ``tests/test_torch_train_{dense,moe,ssm,audio_vlm}.py`` (not a test
file).

Both sides start from the reference's weights carried across
(``torch_model_cases.bridged``) and take the reference loader's batch
(``repro.data.loader.host_batches``, B = 4, S = 32, seed 1).  Tolerances,
each measured on this CPU over the ten reduced ``ASSIGNED`` configs:
- ``make_loss_fn``'s loss, ``lm_loss`` and ``moe_aux`` within
  ``LOSS_ATOL`` = 1e-5 (1.9e-6 at worst);
- each gradient leaf within ``GRAD_RTOL`` = 1e-4 of that leaf's largest
  magnitude (1.6e-6 at worst, mamba2's ``wc``).  A leaf whose largest
  magnitude is under ``GRAD_FLOOR`` = 1e-4 of the tree's largest is held
  at that floor instead: its true gradient is 0 and both sides carry
  rounding noise (whisper's key biases: without RoPE, softmax ignores a
  shift shared by every key; 2.8e-12 against noise of 3.1e-12);
- one ``make_train_step`` at microbatches 1 and 2: ``loss``, ``lm_loss``
  and ``moe_aux`` within ``LOSS_ATOL``, ``grad_norm`` within
  ``GNORM_RTOL`` = 1e-5 relative (5.7e-6 absolute at worst), ``lr``
  exactly.  The parameters after the step are held within 2 lr, not
  tighter: Adam's first step is about lr * sign(g), so an entry whose
  gradient cancels to a few ulps can move by 2 lr on one side only
  (1.7e-4 at worst at lr 1e-3, mamba2);
- the port's gradients with ``remat`` against those without, within
  ``REMAT_RTOL`` = 1e-6 of each leaf's largest magnitude, floored as
  above (8.5e-8 at worst over three runs; 0 on one thread: the
  recomputed layers are bitwise the same, but the embedding's backward
  sums its rows in an order that varies across torch's threads).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.loader import LoaderConfig as RLoaderConfig
from repro.data.loader import host_batches as ref_host_batches
from repro.optim import adamw as RA
from repro.train import steps as RST
from repro_torch.models import meta as M
from repro_torch.optim import adamw as A
from repro_torch.train import steps as ST
from torch_model_cases import bridged, port_cfg

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-4
GNORM_RTOL = 1e-5
REMAT_RTOL = 1e-6
LR = 1e-3
BATCH, SEQ = 4, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for a file that imports this fixture: a train
    step is hundreds of small operations, and where the test workers
    oversubscribe the host's cores each one stalls in torch's thread pool
    (``tests/test_torch_training.py`` has the same fixture)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Case:
    """One reduced config: its reference and port configs, the bridged
    weights and the batch on both sides."""

    def __init__(self, arch):
        self.ref_cfg = ref_get_config(arch).reduced()
        self.cfg = port_cfg(self.ref_cfg)
        self.jp, self.tp = bridged(self.ref_cfg, jax.random.PRNGKey(7), 3)
        block = next(ref_host_batches(self.ref_cfg, RLoaderConfig(
            global_batch=BATCH, seq_len=SEQ, seed=1)))
        self.jbatch = {k: jnp.asarray(v) for k, v in block.items()}
        self.tbatch = {k: torch.from_numpy(v) for k, v in block.items()}


def port_grads(cfg, params, batch, remat=True):
    """(loss, metrics, {leaf path: gradient}) of the port's loss."""
    live = M.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = ST.make_loss_fn(cfg, remat=remat)(live, batch)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        p: (torch.zeros_like(t) if t.grad is None
                               else t.grad) for p, t in M.leaves(live)}


def check_loss_and_grads(case):
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        RST.make_loss_fn(case.ref_cfg, remat=True), has_aux=True))(
            case.jp, case.jbatch)
    loss, metrics, grads = port_grads(case.cfg, case.tp, case.tbatch)
    assert abs(float(loss) - float(jl)) <= LOSS_ATOL
    for k in ("lm_loss", "moe_aux"):
        assert abs(float(metrics[k]) - float(jm[k])) <= LOSS_ATOL, k
    assert (float(metrics["moe_aux"]) > 0) == case.cfg.is_moe
    want = dict(M.leaves(jax.tree.map(np.asarray, jg)))
    assert set(grads) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        gap = float(np.abs(grads[path].numpy() - w).max())
        assert gap <= GRAD_RTOL * scale, (path, gap, scale)


def check_train_step(case, microbatches):
    opt = RA.AdamWConfig(lr=LR)
    jstate = RST.TrainState(case.jp, RA.init(case.jp),
                            jnp.zeros((), jnp.int32))
    jnew, jm = jax.jit(RST.make_train_step(
        case.ref_cfg, opt, remat=True, microbatches=microbatches))(
            jstate, case.jbatch)
    tstate = ST.TrainState(case.tp, A.init(case.tp),
                           torch.zeros((), dtype=torch.int32))
    tnew, tm = ST.make_train_step(
        case.cfg, A.AdamWConfig(lr=LR), remat=True,
        microbatches=microbatches)(tstate, case.tbatch)
    assert set(tm) == set(jm) == {"lm_loss", "moe_aux", "grad_norm", "lr",
                                  "loss"}
    for k in ("loss", "lm_loss", "moe_aux"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_ATOL, k
    gnorm = float(jm["grad_norm"])
    assert abs(float(tm["grad_norm"]) - gnorm) <= GNORM_RTOL * gnorm
    assert float(tm["lr"]) == float(jm["lr"])
    assert int(tnew.step) == int(jnew.step) == 1
    assert int(tnew.opt.count) == 1
    want = dict(M.leaves(jax.tree.map(np.asarray, jnew.params)))
    before = dict(M.leaves(case.tp))
    moved = 0.0
    for path, got in M.leaves(tnew.params):
        gap = float(np.abs(got.numpy() - want[path]).max())
        assert gap <= 2 * LR, (path, gap)
        moved = max(moved, float((got - before[path]).abs().max()))
    assert moved > 0


def check_remat_gradients_equal(case):
    """Recomputing each layer in the backward pass gives the gradients
    without it, within ``REMAT_RTOL`` of each leaf's largest magnitude
    (floored as above)."""
    _, _, with_remat = port_grads(case.cfg, case.tp, case.tbatch, remat=True)
    _, _, without = port_grads(case.cfg, case.tp, case.tbatch, remat=False)
    top = max(float(g.abs().max()) for g in without.values())
    for path, g in without.items():
        scale = max(float(g.abs().max()), GRAD_FLOOR * top)
        gap = float((with_remat[path] - g).abs().max())
        assert gap <= REMAT_RTOL * scale, (path, gap, scale)
