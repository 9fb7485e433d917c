"""Step factories: the LLM train step and the prefill, decode and
classify closures the serving launcher calls.

``make_train_step`` is the reference's: the next-token loss over text
positions (plus the MoE's load-balance term), gradients by autograd,
optional gradient accumulation over microbatches, then AdamW.  Nothing is
jitted: a step is a plain call on the parameters' device.

Every factory takes the reference's ``ctx``.  With a
``distributed.sharding.ActCtx`` the parameters (and caches, and batches)
are DTensors on its mesh: the step runs inside ``ctx.scope()``, where the
plain tensors the model makes join DTensor operations as replicated, and
the model applies ``ctx`` at the reference's constraint sites.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (is_dtensor, like_rows,
                                             on_positions, scope,
                                             split_batch, split_dims,
                                             splits_last, take_last)
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: M.Tree
    opt: adamw.AdamWState
    step: torch.Tensor         # int32 ()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token xent: logits (B, S, V), cast to f32, labels (B, S)
    integer.  DTensor logits may hold a prefix of positions before the
    labels' (internvl2's image prefix, which ``make_loss_fn`` leaves on
    where the sequence is split); it is left out."""
    lf = logits.to(torch.float32)
    idx = labels.long()[..., None]
    prefix = lf.shape[1] - labels.shape[1]
    if prefix and not split_dims(lf, 1):
        lf = lf[:, prefix:]
    if not splits_last(lf):
        if split_dims(lf, 1):    # a split sequence: each shard's positions
            return on_positions(_xent_terms, lf, idx) / labels.numel()
        return torch.mean(_xent_terms(lf, idx))
    # vocabulary-sharded DTensor logits: logsumexp as its max-shifted sum,
    # whose max and sum reduce (B, S) partials across the shards (the max
    # a constant for autograd, as in logsumexp's own backward), where
    # torch.logsumexp would gather the logits; the label logit gathered
    # shard by shard (take_last), where torch.gather's backward would
    # gather them too; every per-row term pinned to the logits' row
    # layout (like_rows), so its gradient spreads back over the vocabulary
    # with no collective
    m = like_rows(torch.amax(lf, dim=-1, keepdim=True), lf).detach()
    lse = m + torch.log(like_rows(torch.sum(torch.exp(lf - m), dim=-1,
                                            keepdim=True), lf))
    return torch.mean(lse - like_rows(take_last(lf, idx), lf))


def _xent_terms(lf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-position xent of f32 logits (B, S, V) at labels (B, S, 1)."""
    return torch.logsumexp(lf, dim=-1) - torch.gather(lf, -1, idx)[..., 0]


def make_loss_fn(cfg: ModelConfig, *, remat: bool = True,
                 remat_policy: Optional[str] = None, ctx=None) -> Callable:
    """(params, batch) -> (loss, {"lm_loss", "moe_aux"}).  ``batch``
    holds ``tokens`` and ``labels`` (B, S), plus ``img_embeds`` or
    ``audio_frames`` where the model takes them; the loss covers the text
    positions only, and a MoE adds ``router_aux_coef`` x its aux loss
    (``lm_loss`` is that total, as the reference reports it)."""
    def loss_fn(params, batch: Dict[str, torch.Tensor]):
        h, aux = T.forward(cfg, params, batch["tokens"],
                           img_embeds=batch.get("img_embeds"),
                           audio_frames=batch.get("audio_frames"),
                           remat=remat, remat_policy=remat_policy, ctx=ctx)
        # loss only over text positions; a split sequence keeps its
        # prefix (cut, it would move every shard's rows: cross_entropy
        # leaves it out)
        if cfg.num_img_tokens > 0 and not split_dims(h, 1):
            h = h[:, cfg.num_img_tokens:]
        loss = cross_entropy(T.lm_logits(cfg, params, h, ctx=ctx),
                             batch["labels"])
        if cfg.is_moe:
            loss = loss + cfg.router_aux_coef * aux
        return loss, {"lm_loss": loss, "moe_aux": aux}
    return loss_fn


def default_microbatches(cfg: ModelConfig, global_batch: int,
                         data_shards: int) -> int:
    """Gradient-accumulation factor so per-micro activations fit HBM."""
    per_shard = max(global_batch // max(data_shards, 1), 1)
    want = 8 if cfg.param_count() > 2e9 else 4
    m = 1
    while m < want and per_shard % (m * 2) == 0:
        m *= 2
    return m


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *,
                    remat: bool = True, microbatches: int = 1,
                    remat_policy: Optional[str] = None,
                    ctx=None) -> Callable:
    """(state, batch) -> (next state, metrics), the reference's step.

    Gradients come from ``torch.autograd.grad`` over a detached copy of
    the parameters (a leaf the loss does not reach, such as ``cls_head``,
    gets zeros).  ``microbatches > 1`` splits the batch along dim 0 into M
    sequential microbatches (a DTensor batch by each shard's rows,
    ``sharding.split_batch``), accumulates their gradients in f32 and
    divides the gradients, the loss and the aux loss by M.  Then
    ``adamw.apply``; the metrics are ``lm_loss``, ``moe_aux``,
    ``grad_norm``, ``lr`` and ``loss`` (plain tensors, reduced over the
    mesh where the step ran on one), and ``step`` goes up by one."""
    loss_fn = make_loss_fn(cfg, remat=remat, remat_policy=remat_policy,
                           ctx=ctx)

    def grads_of(params, batch) -> Tuple[torch.Tensor, dict, M.Tree]:
        flat = []

        def live(t):
            flat.append(t.detach().requires_grad_(True))
            return flat[-1]

        def grad(p):         # tree_map visits leaves in ``live``'s order
            g = next(grads)
            return torch.zeros_like(p) if g is None else g

        loss, metrics = loss_fn(M.tree_map(live, params), batch)
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                M.tree_map(grad, params))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with scope(ctx):
            return step(state, batch)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            loss, metrics, grads = grads_of(state.params, batch)
        else:
            for name, leaf in batch.items():
                if leaf.shape[0] % microbatches:
                    raise ValueError(f"batch {name!r} of {leaf.shape[0]} "
                                     f"rows does not split into "
                                     f"{microbatches} microbatches")
            micro = {k: split_batch(v, microbatches)
                     for k, v in batch.items()}
            # f32 accumulators laid out as the parameters
            grads = M.tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            aux = torch.zeros_like(loss)
            for i in range(microbatches):
                mb_loss, mb_metrics, g = grads_of(
                    state.params, {k: v[i] for k, v in micro.items()})
                grads = M.tree_map(lambda a, b: a + b.to(torch.float32),
                                   grads, g)
                loss = loss + mb_loss
                aux = aux + mb_metrics["moe_aux"]
            grads = M.tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {"lm_loss": loss, "moe_aux": aux / microbatches}
        new_params, new_opt, opt_metrics = adamw.apply(
            opt_cfg, grads, state.opt, state.params)
        metrics = dict(metrics, **opt_metrics, loss=loss)
        return TrainState(new_params, new_opt, state.step + 1), {
            k: v.full_tensor() if is_dtensor(v) else v
            for k, v in metrics.items()}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, cache_len: Optional[int] = None,
                      window: Optional[int] = None, ctx=None) -> Callable:
    """(params, {"tokens": (B, S)}, plus ``img_embeds`` or
    ``audio_frames`` where the model takes them) -> (logits (B, V),
    cache); attention sees at most ``window`` positions back."""
    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        with scope(ctx):
            return T.prefill(cfg, params, batch["tokens"],
                             cache_len=cache_len,
                             img_embeds=batch.get("img_embeds"),
                             audio_frames=batch.get("audio_frames"),
                             window=window, ctx=ctx)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, window: Optional[int] = None,
                     ctx=None) -> Callable:
    """(params, cache, token (B,)) -> (logits (B, V), cache); attention
    sees at most ``window`` positions back (a ring cache of that length
    holds a long context)."""
    @torch.no_grad()
    def decode_step(params, cache, token):
        with scope(ctx):
            return T.decode_step(cfg, params, cache, token, window=window,
                                 ctx=ctx)
    return decode_step


def make_classify_fn(cfg: ModelConfig, ctx=None) -> Callable:
    """CQ-specific classifier forward (the cascade's edge model):
    (params, {"tokens": (B, S)}, plus ``img_embeds`` or ``audio_frames``
    where the model takes them) -> (B, num_query_classes) logits."""
    @torch.no_grad()
    def classify(params, batch: Dict[str, torch.Tensor]):
        with scope(ctx):
            h, _ = T.forward(cfg, params, batch["tokens"],
                             img_embeds=batch.get("img_embeds"),
                             audio_frames=batch.get("audio_frames"),
                             ctx=ctx)
            return T.classify(cfg, params, h)
    return classify
