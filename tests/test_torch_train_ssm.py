"""The port's LLM train step against the reference's on the SSM families
(mamba2, and hymba's attention and SSM heads), reduced, on the CPU:
``make_loss_fn``'s loss and gradients (through the chunked SSD and the
depthwise convolutions), one ``make_train_step`` at microbatches 1 and 2,
and ``remat``.  The tolerances, each measured, are
in ``tests/torch_train_cases.py``'s docstring.
"""
import pytest

from torch_train_cases import (Case, check_loss_and_grads,
                               check_remat_gradients_equal, check_train_step,
                               one_torch_thread)  # noqa: F401

FAMILIES = ["mamba2-2.7b", "hymba-1.5b"]


@pytest.fixture(scope="module", params=FAMILIES)
def case(request):
    return Case(request.param)


def test_loss_and_grads_match_reference(case):
    check_loss_and_grads(case)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(case, microbatches):
    check_train_step(case, microbatches)


def test_remat_gradients_equal_plain_gradients(case):
    check_remat_gradients_equal(case)
