"""CQ-specific fine-tuning (paper §IV-B, Fig. 5).

When a new query arrives, a lightweight edge model is fine-tuned from shared
pre-trained weights on the cluster's context-specific dataset, then shipped
to the edge.  Three schemes, matching the paper's Fig. 5 comparison:

  * ``surveiledge``  — fine-tune from pre-trained weights on *cluster* data
                       (small LR, few steps; the paper's scheme: ~8x faster
                       than All-Fine-tune at nearly equal accuracy)
  * ``all_finetune`` — train per *camera* from scratch-ish (high LR, many
                       steps x num cameras; the expensive upper bound)
  * ``no_finetune``  — pre-trained weights used as-is (zero training time,
                       low accuracy on the specific query)

The trainer (``finetune``, ``run_scheme``) runs autograd over
``models/transformer.py::forward`` and ``classify`` with the port's
AdamW (``optim/adamw.py``), on the device the parameters live on; the
analytic cost the runtime query lifecycle charges (``system/queries.py``)
is ``scheme_train_time``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


@dataclasses.dataclass
class FinetuneResult:
    params: Any
    steps: int
    train_seconds: float
    final_loss: float
    accuracy: float
    # wall seconds of each step, batch draw included, each ending when its
    # loss is on the host (they sum to train_seconds), and each step's loss
    step_seconds: Tuple[float, ...] = ()
    step_losses: Tuple[float, ...] = ()


def _device_of(params) -> torch.device:
    return params["embed"].device


def classifier_loss(cfg: ModelConfig, params, tokens: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Binary/k-way xent on the CQ classifier head."""
    h, _ = T.forward(cfg, params, tokens)
    logits = T.classify(cfg, params, h)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - ll)


@torch.no_grad()
def accuracy_of(cfg: ModelConfig, params, tokens: torch.Tensor,
                labels: torch.Tensor) -> float:
    dev = _device_of(params)
    h, _ = T.forward(cfg, params, tokens.to(dev))
    pred = torch.argmax(T.classify(cfg, params, h), dim=-1)
    return float(torch.mean((pred == labels.to(dev)).to(torch.float32)))


def finetune(cfg: ModelConfig,
             params: Any,
             data_iter: Iterable[Tuple[torch.Tensor, torch.Tensor]],
             *,
             steps: int = 50,
             lr: float = 1e-3,
             head_only: bool = False,
             eval_set: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> FinetuneResult:
    """Fine-tune ``params`` on (tokens, labels) batches, on the params'
    device; takes exactly ``steps`` batches from ``data_iter`` (fewer if
    it ends first).

    ``head_only=True`` freezes the backbone (linear probe) — the fastest
    variant of the paper's scheme for tiny time budgets.
    """
    opt_cfg = adamw.AdamWConfig(lr=lr, weight_decay=0.01, clip_norm=1.0)
    opt = adamw.init(params)
    dev = _device_of(params)

    def step(params, opt, tokens, labels):
        live = M.tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = classifier_loss(cfg, live, tokens, labels)
        loss.backward()
        # a leaf the loss does not reach (an untied lm_head) has grad 0
        grads = M.tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                           else t.grad, live)
        new_params, new_opt, _ = adamw.apply(opt_cfg, grads, opt, params)
        if head_only:
            # linear probe: only the classifier head moves (note: a grad
            # mask alone would still leak weight decay into the backbone)
            new_params = {k: v if k == "cls_head" else params[k]
                          for k, v in new_params.items()}
        return new_params, new_opt, loss.detach()

    t0 = t_prev = time.time()
    times, losses = [], []
    for tokens, labels in data_iter:
        params, opt, loss_t = step(params, opt, tokens.to(dev),
                                   labels.to(dev))
        losses.append(float(loss_t))
        now = time.time()
        times.append(now - t_prev)
        t_prev = now
        if len(losses) >= steps:
            break
    dt = time.time() - t0
    acc = accuracy_of(cfg, params, *eval_set) if eval_set is not None \
        else float("nan")
    return FinetuneResult(params, len(losses), dt,
                          losses[-1] if losses else float("nan"), acc,
                          tuple(times), tuple(losses))


def pretrain_backbone(cfg: ModelConfig, generator: torch.Generator,
                      data_iter: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                      steps: int = 100, lr: float = 1e-3,
                      device="cuda") -> Any:
    """'ImageNet pre-training' analogue: generic multi-class pretraining of
    the edge backbone on pooled (all-cluster) data.  The init draws from
    ``generator`` (a CPU generator), and training runs on ``device`` (the
    card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    params = M.tree_map(lambda t: t.to(dev), M.init_params(cfg, generator))
    res = finetune(cfg, params, data_iter, steps=steps, lr=lr)
    return res.params


# Fig. 5 training-step budget shared by the real trainer (`run_scheme`
# below) and the runtime cost model (`scheme_train_time`): both express the
# same scheme trade — SurveilEdge fits ONE cluster model in `FIG5_STEPS`
# steps, All-Fine-tune fits one model PER CAMERA (the ~num_cameras-x
# slower upper bound), No-Fine-tune trains nothing.
FIG5_STEPS = 40
FIG5_SCHEMES = ("surveiledge", "all_finetune", "no_finetune")


def scheme_train_time(scheme: str, num_cameras: int, *,
                      step_s: float = 0.05) -> float:
    """Simulated cloud seconds to fine-tune one CQ model under ``scheme``.

    This is the Fig. 5 trade as an analytic cost the runtime query
    lifecycle charges on arrival (``system/queries.py``): ``step_s`` is
    the cloud's per-optimizer-step wall clock, and the step counts mirror
    ``run_scheme`` exactly.
    """
    if scheme == "no_finetune":
        return 0.0
    if scheme == "surveiledge":
        return FIG5_STEPS * step_s
    if scheme == "all_finetune":
        return FIG5_STEPS * step_s * max(int(num_cameras), 1)
    raise ValueError(
        f"unknown Fig. 5 training scheme {scheme!r} "
        f"(expected one of {FIG5_SCHEMES})")


def run_scheme(scheme: str,
               cfg: ModelConfig,
               pretrained: Any,
               cluster_iter_fn: Callable[[], Iterable],
               camera_iter_fns: Dict[int, Callable[[], Iterable]],
               eval_set) -> Dict[int, FinetuneResult]:
    """Dispatch the Fig. 5 training schemes.  Returns per-target results
    (key -1: the one cluster model; else a camera id)."""
    if scheme == "no_finetune":
        acc = accuracy_of(cfg, pretrained, *eval_set)
        return {-1: FinetuneResult(pretrained, 0, 0.0, float("nan"), acc)}
    if scheme == "surveiledge":
        res = finetune(cfg, pretrained, cluster_iter_fn(),
                       steps=FIG5_STEPS, lr=5e-4, eval_set=eval_set)
        return {-1: res}
    if scheme == "all_finetune":
        out = {}
        for cam, it_fn in camera_iter_fns.items():
            out[cam] = finetune(cfg, pretrained, it_fn(),
                                steps=FIG5_STEPS, lr=5e-4, eval_set=eval_set)
        return out
    raise ValueError(scheme)
