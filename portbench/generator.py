"""The one traffic generator: bursts of requests from a mix's parameters
(``traffic/<name>.json``) and the run's ``--seed``.

A burst holds ``burst`` requests.  Its prompt lengths are the ``burst``
quantiles (i + 0.5) / burst of the log-uniform distribution over
``prompt_tokens`` [lo, hi], and its answer lengths (``max_new``) those of
``answer_tokens``, each list in an order the seed draws.  So every burst of
every seed carries the same work in another order, and runs of different
seeds differ by which prompts the edge settles, not by their sizes.

Each request draws its tokens uniformly from a topic of its own:
``topic_ids`` distinct ids, drawn from the ids both models know (the
edge model's vocabulary is the smaller).  Real prompts use a topic's
words; pooled over thousands of tokens, uniform ids would give every
prompt the same edge confidence.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Spec:
    """One request of a burst: its id, prompt and answer length."""
    rid: int
    tokens: np.ndarray
    max_new: int


def quantile_lengths(lo: int, hi: int, n: int) -> List[int]:
    """The n quantiles (i + 0.5) / n of the log-uniform over [lo, hi]."""
    a, b = math.log(lo), math.log(hi)
    return [int(round(math.exp(a + (i + 0.5) / n * (b - a))))
            for i in range(n)]


def _rng(seed: int, burst: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [abs(int(seed)), int(seed < 0), burst]))


def burst(mix: Dict, seed: int, index: int, vocab: int) -> List[Spec]:
    """Burst ``index`` of a run with seed ``seed``: ``mix["burst"]``
    requests, ids ``index * burst + i``, token ids below ``vocab``."""
    n = mix["burst"]
    rng = _rng(seed, index)
    prompts = rng.permutation(quantile_lengths(*mix["prompt_tokens"], n))
    answers = rng.permutation(quantile_lengths(*mix["answer_tokens"], n))
    out = []
    for i in range(n):
        topic = rng.choice(vocab, size=min(mix["topic_ids"], vocab),
                           replace=False)
        toks = topic[rng.integers(0, topic.size, size=int(prompts[i]))]
        out.append(Spec(rid=index * n + i, tokens=toks.astype(np.int32),
                        max_new=int(answers[i])))
    return out
