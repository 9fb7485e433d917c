"""The port's LLM train step against the reference's on the MoE family
(phi3.5-moe, granite-moe), reduced, on the CPU: ``make_loss_fn``'s loss,
``lm_loss``, the router's ``moe_aux`` and gradients (through the
sort-dispatched experts), one ``make_train_step`` at microbatches 1 and 2,
and ``remat``.  The tolerances, each measured, are
in ``tests/torch_train_cases.py``'s docstring.
"""
import pytest

from torch_train_cases import (Case, check_loss_and_grads,
                               check_remat_gradients_equal, check_train_step,
                               one_torch_thread)  # noqa: F401

FAMILIES = ["phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m"]


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
