"""Step factories: the prefill, decode and classify closures the serving
launcher calls.

Of the reference's ``train/steps.py`` the port carries the three
inference closures; the train step (loss, AdamW, microbatching) comes
with a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, *,
                      cache_len: Optional[int] = None) -> Callable:
    """(params, {"tokens": (B, S)}, plus ``img_embeds`` or
    ``audio_frames`` where the model takes them) -> (logits (B, V),
    cache)."""
    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        return T.prefill(cfg, params, batch["tokens"], cache_len=cache_len,
                         img_embeds=batch.get("img_embeds"),
                         audio_frames=batch.get("audio_frames"))
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(params, cache, token (B,)) -> (logits (B, V), cache)."""
    @torch.no_grad()
    def decode_step(params, cache, token):
        return T.decode_step(cfg, params, cache, token)
    return decode_step


def make_classify_fn(cfg: ModelConfig) -> Callable:
    """CQ-specific classifier forward (the cascade's edge model):
    (params, {"tokens": (B, S)}, plus ``img_embeds`` or ``audio_frames``
    where the model takes them) -> (B, num_query_classes) logits."""
    @torch.no_grad()
    def classify(params, batch: Dict[str, torch.Tensor]):
        h, _ = T.forward(cfg, params, batch["tokens"],
                         img_embeds=batch.get("img_embeds"),
                         audio_frames=batch.get("audio_frames"))
        return T.classify(cfg, params, h)
    return classify
