"""AdamW with decoupled weight decay and global-norm clipping (from scratch).

State layout mirrors the param tree (``m``/``v`` are f32 regardless of param
dtype), over the nested-dict parameter trees of ``models/meta.py``.  The
arithmetic is the reference's, operation for operation: f32 moments,
``scale = min(1, clip_norm / (gnorm + 1e-9))``, bias corrections
``1 - b ** count`` in f32, and weight decay on every leaf with
``ndim >= 2`` (the stacked ``(L, D)`` norm scales under ``layers`` decay,
the final norm's ``(D,)`` scale does not).  Every tensor of a step stays
on the parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.models.meta import Tree, leaves, tree_map


class AdamWState(NamedTuple):
    count: torch.Tensor        # int32 ()
    m: Tree                    # f32 tree
    v: Tree                    # f32 tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if self.schedule is None:
            return torch.tensor(self.lr, dtype=torch.float32,
                                device=step.device)
        return self.lr * self.schedule(step)


def init(params: Tree) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = next(leaves(params))[1].device
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros, v=tree_map(torch.clone, zeros))


def abstract_state(params: Tree) -> AdamWState:
    """The state ``init`` would give, as storage-free f32 tensors on the
    parameters' device (``meta``, or fake under a ``FakeTensorMode``)."""
    z = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    device = next(leaves(params))[1].device
    return AdamWState(count=torch.empty((), dtype=torch.int32, device=device),
                      m=z, v=z)


def global_norm(tree: Tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for _, g in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def apply(cfg: AdamWConfig, grads: Tree, state: AdamWState, params: Tree):
    """Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** cf
    bc2 = 1.0 - cfg.b2 ** cf
    lr = cfg.lr_at(count)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        decay = cfg.weight_decay * pf if p.ndim >= 2 else 0.0
        newp = pf - lr * (step + decay)
        return newp.to(p.dtype), m, v

    out = tree_map(upd, grads, state.m, state.v, params)
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), AdamWState(count, pick(1), pick(2)), metrics
