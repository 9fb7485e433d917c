"""The CQ classifier's trunk: token embedding, dense decoder blocks, final
norm, and the cascade's classification head (mean-pool, then linear).

The cache-free subset of the reference's ``models/transformer.py``: the
reference scans stacked layer parameters with ``lax.scan``; here a Python
loop over layers indexes the same stacked tensors.  ``CQClassifier`` wraps
config and parameters on an explicit device and maps (N, T) patch tokens
to (N,) P(query object) — what ``kernels.ops.score_crops`` calls once per
tick.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.cascade import confidence_from_logits
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import meta as M
from repro_torch.models.config import ModelConfig

Params = Dict[str, object]


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def decoder_block(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
                  q_pos: torch.Tensor) -> torch.Tensor:
    """One dense layer without a cache: x + attn(norm(x)), then
    x + mlp(norm(x)), causal over the sequence."""
    h = L.norm_apply(cfg, lp["norm1"], x)
    q, k, v = L.qkv_project(cfg, lp["attn"], h)
    cos, sin = L.rope_freqs(cfg, q_pos)
    q = L.apply_rope(cfg, q, cos, sin)
    k = L.apply_rope(cfg, k, cos, sin)
    o = L.attention(cfg, q, k, v, q_pos, q_pos, causal=True)
    x = x + L.attn_out(lp["attn"], o)
    h2 = L.norm_apply(cfg, lp["norm2"], x)
    return x + L.mlp_apply(cfg, lp["mlp"], h2)


def forward(cfg: ModelConfig, params: Params,
            tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> hidden (B, S, D)."""
    x = embed_tokens(cfg, params, tokens)
    q_pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for i in range(cfg.num_layers):
        lp = M.tree_map(lambda t: t[i], params["layers"])
        x = decoder_block(cfg, lp, x, q_pos=q_pos)
    return L.norm_apply(cfg, params["final_norm"], x)


def classify(cfg: ModelConfig, params: Params,
             hidden: torch.Tensor) -> torch.Tensor:
    """CQ-specific classifier head: mean-pool over the sequence, then
    linear -> (B, num_query_classes) logits, in f32."""
    pooled = torch.mean(hidden.to(torch.float32), dim=1)
    head = params["cls_head"]
    return pooled @ head["w"].to(torch.float32) + head["b"].to(torch.float32)


class CQClassifier(torch.nn.Module):
    """The CQ model on one device: (N, T) patch tokens -> (N,) P(query
    object), the confidence of ``query_class`` under a softmax."""

    def __init__(self, cfg: ModelConfig, params: Params, *, device,
                 query_class: int = 1):
        super().__init__()
        M.check_dense(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.query_class = query_class
        self.params = M.tree_map(lambda t: t.to(self.device), params)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        h = forward(self.cfg, self.params, tokens.to(self.device))
        return confidence_from_logits(classify(self.cfg, self.params, h),
                                      self.query_class)
