"""The port's LLM train step against the reference's on the dense
family (qwen1.5-0.5b, qwen3-8b, chatglm3-6b, command-r-35b), reduced, on
the CPU: ``cross_entropy``, ``make_loss_fn``'s loss and gradients, one
``make_train_step`` at microbatches 1 and 2, ``remat``, and
``default_microbatches``.  The tolerances, each measured, are in
``tests/torch_train_cases.py``'s docstring; ``cross_entropy`` is held
within ``LOSS_ATOL`` (f32, the same operations: 1.9e-6, two ulps at
9.6), ``default_microbatches`` exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as REF_ASSIGNED
from repro.configs import get_config as ref_get_config
from repro.train import steps as RST
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.optim import adamw as A
from repro_torch.train import steps as ST
from torch_train_cases import (LOSS_ATOL, Case, check_loss_and_grads,
                               check_remat_gradients_equal, check_train_step,
                               one_torch_thread)  # noqa: F401

DENSE = ["qwen1.5-0.5b", "qwen3-8b", "chatglm3-6b", "command-r-35b"]


@pytest.fixture(scope="module", params=DENSE)
def case(request):
    return Case(request.param)


def test_loss_and_grads_match_reference(case):
    check_loss_and_grads(case)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(case, microbatches):
    check_train_step(case, microbatches)


def test_remat_gradients_equal_plain_gradients(case):
    check_remat_gradients_equal(case)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (4.0 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(RST.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = ST.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= LOSS_ATOL
    # bf16 logits are cast to f32 first on both sides
    want16 = float(RST.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                                     jnp.asarray(labels)))
    got16 = ST.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                             torch.from_numpy(labels))
    assert abs(float(got16) - want16) <= LOSS_ATOL


def test_default_microbatches_matches_reference():
    assert ASSIGNED == REF_ASSIGNED
    for arch in ASSIGNED:
        for variant in ("full", "reduced"):
            cfg, ref = get_config(arch), ref_get_config(arch)
            if variant == "reduced":
                cfg, ref = cfg.reduced(), ref.reduced()
            for batch in (1, 2, 3, 4, 8, 12, 16, 64, 256):
                for shards in (0, 1, 2, 4, 16):
                    assert ST.default_microbatches(cfg, batch, shards) == \
                        RST.default_microbatches(ref, batch, shards), \
                        (arch, variant, batch, shards)


def test_microbatches_must_divide_the_batch(case):
    state = ST.TrainState(case.tp, A.init(case.tp),
                          torch.zeros((), dtype=torch.int32))
    step = ST.make_train_step(case.cfg, A.AdamWConfig(), microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(state, case.tbatch)


def test_remat_policy_is_refused(case):
    """A policy the reference does not have is refused; its two
    ("dots", "dots_no_batch") are held against plain remat in
    ``tests/test_torch_multidevice.py``."""
    with pytest.raises(ValueError, match="remat_policy"):
        ST.make_loss_fn(case.cfg, remat_policy="dots_all")(case.tp,
                                                           case.tbatch)
