"""Seeded weights for a configuration, in the layout the served program
takes: a nested dict of tensors with every layer's leaves stacked on a
leading axis of size ``num_layers``.

The benchmark makes the weights; the program under test and the plain
reference (``reference/``) read the same tensors, laid out as the
reference's family files say.  Every number
comes from one ``torch.randn`` call on a generator of the target device
seeded from ``--seed``, so set-up draws 1.3 billion values in one launch
and the same seed gives the same weights.  Each leaf is a slice of that
buffer, scaled by its gain over the square root of its fan-in (the
``init`` map of the configuration file); ``"residual"`` is
``1/sqrt(2 * num_layers)``, so the trunk's 2L residual branches add up
to the scale of one.  Norm scales are 1 plus a jitter and biases are
small, so a program that drops a bias or a norm scale reads differently.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

from portbench.reference import model as REF

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, int]


def derive_seed(seed: int, *tags: str) -> int:
    """A 63-bit seed for one purpose (``tags``) of a run's ``--seed``."""
    h = hashlib.sha256(":".join([str(int(seed)), *tags]).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def leaves(m: Dict) -> List[Leaf]:
    """(path, shape, kind, fan_in) of every leaf of model ``m`` (a
    configuration's ``model`` or ``edge`` section), in a fixed order: the
    embedding, the layers' leaves as the family's reference reads them
    (``reference/<family>.py``'s ``layer_leaves``), the final norm and the
    classifier.  kind: a gain key of ``init``, or ``bias``, ``norm``."""
    D, V, C = m["d_model"], m["vocab_size"], m["num_query_classes"]
    return ([(("embed",), (V, D), "embed", D)]
            + [(("layers",) + path, shape, kind, fan_in) for
               path, shape, kind, fan_in in REF.family(m).layer_leaves(m)]
            + [(("final_norm", "scale"), (D,), "norm", 0),
               (("cls_head", "w"), (D, C), "cls", D),
               (("cls_head", "b"), (C,), "bias", 0)])


def count(m: Dict) -> int:
    """Parameters of model ``m``."""
    return sum(math.prod(shape) for _, shape, _, _ in leaves(m))


def _gain(init: Dict, kind: str, num_layers: int) -> float:
    g = init[kind]
    return 1.0 / math.sqrt(2 * num_layers) if g == "residual" else float(g)


@torch.no_grad()
def make(m: Dict, init: Dict, seed: int, tag: str, device) -> Dict:
    """The weight tree of model ``m`` for run seed ``seed`` on ``device``
    (``tag`` keeps the cloud's and the edge's draws apart)."""
    specs = leaves(m)
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, "weights", tag))
    flat = torch.randn(sum(math.prod(s) for _, s, _, _ in specs),
                       generator=gen, device=device, dtype=torch.float32)
    tree: Dict = {}
    at = 0
    for path, shape, kind, fan_in in specs:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "norm":
            t.mul_(init["norm_jitter"]).add_(1.0)
        elif kind == "bias":
            t.mul_(init["bias"])
        else:
            t.mul_(_gain(init, kind, m["num_layers"]) / math.sqrt(fan_in))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree
