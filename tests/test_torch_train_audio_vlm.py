"""The port's LLM train step against the reference's on whisper-large-v3
(encoder-decoder, stub audio frames) and internvl2-1b (image prefix, the
loss over text positions only), reduced, on the CPU: ``make_loss_fn``'s
loss and gradients (the encoder's and ``img_proj``'s included), one
``make_train_step`` at microbatches 1 and 2 (the frames and image
embeddings split with the tokens), and ``remat`` (encoder layers too).
The tolerances, each measured, are in ``tests/torch_train_cases.py``'s
docstring.
"""
import pytest

from torch_train_cases import (Case, check_loss_and_grads,
                               check_remat_gradients_equal, check_train_step,
                               one_torch_thread)  # noqa: F401

FAMILIES = ["whisper-large-v3", "internvl2-1b"]


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


def test_batch_carries_the_stub_inputs(case):
    assert ("audio_frames" in case.tbatch) == case.cfg.is_encdec
    assert ("img_embeds" in case.tbatch) == (case.cfg.num_img_tokens > 0)
