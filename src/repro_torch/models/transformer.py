"""Trunk of the dense models: token embedding, decoder blocks (sequential,
or command-r's parallel attention and MLP from one norm), final norm, the
LM and classification heads, and the prefill/decode cache (in the
activations' dtype, or int8 with per-token scales).

The dense subset of the reference's ``models/transformer.py``: the
reference scans stacked layer parameters with ``lax.scan``; here a Python
loop over layers indexes the same stacked tensors.  Weights may be served
in int8 (``distributed.quantize.quantize_tree``): the loop dequantizes one
layer's slice at a time (``maybe_dequant``) in the activations' dtype,
and the embedding's int8 rows come out in bf16, so an int8-weight model
computes in bf16.  Two users:

* the pixel path's CQ classifier: ``forward`` + ``classify``, wrapped on
  an explicit device by ``CQClassifier``, which maps (N, T) patch tokens
  to (N,) P(query object) — what ``kernels.ops.score_crops`` calls once a
  tick;
* the serving path (``serving/engine.py``): ``prefill`` writes a decode
  cache and returns the last position's logits, ``decode_step`` decodes
  one token per sequence against it.  Positions are per sequence, so
  slots at different prefix lengths share one decode batch.

The cache is updated in place (the reference returns a new one): prefill
writes its own fresh cache, and ``decode_step`` writes each layer's new
K/V row into the cache it is given and returns that same storage, so a
caller never holds two copies of a multi-GB cache.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.cascade import confidence_from_logits
from repro_torch.distributed import quantize as QZ
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import meta as M
from repro_torch.models.config import ModelConfig

Params = Dict[str, object]
Cache = Dict[str, object]


def maybe_dequant(tree, dtype: torch.dtype = torch.bfloat16):
    """Dequantize int8-served weights (``{"q", "s"}`` leaves) to
    ``dtype``; float leaves pass unchanged."""
    return QZ.dequant_tree(tree, dtype)


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    if isinstance(emb, dict):        # int8-served: gather rows, then scale
        rows = emb["q"][tokens].to(torch.float32)
        return (rows * emb["s"]).to(torch.bfloat16)
    return emb[tokens]


def decoder_block(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
                  q_pos: torch.Tensor,
                  k_pos: Optional[torch.Tensor] = None,
                  cache: Optional[Cache] = None, decode: bool = False,
                  window: Optional[int] = None) -> torch.Tensor:
    """One dense layer: x + attn(norm(x)), then x + mlp(norm(x)); under
    ``parallel_block`` (command-r) x + attn(h) + mlp(h) from one norm h.

    Without ``decode``: causal attention over the sequence itself; with a
    ``cache`` (a layer's ``{"k", "v"}`` of shape (B, W, KV, hd), plus
    ``{"k_scale", "v_scale"}`` (B, W, KV) under ``kv_cache_dtype="int8"``)
    the rotated K and V are written, in place, to its first S positions
    (prefill; int8 values and their scales under int8, while attention
    reads the unquantized K/V).  With ``decode``: x is one token per row at
    ``q_pos`` (B, 1); its K/V go to slot ``q_pos % W`` of row b, and
    attention reads the whole cache (dequantized to q's dtype under int8)
    under ``k_pos`` (B, W)."""
    h = L.norm_apply(cfg, lp["norm1"], x)
    q, k, v = L.qkv_project(cfg, lp["attn"], h)
    cos, sin = L.rope_freqs(cfg, q_pos)
    q = L.apply_rope(cfg, q, cos, sin)
    k = L.apply_rope(cfg, k, cos, sin)
    int8_kv = cfg.kv_cache_dtype == "int8"
    if decode:
        kc, vc = cache["k"], cache["v"]              # (B, W, KV, hd)
        B, W = kc.shape[:2]
        rows = torch.arange(B, device=kc.device)
        slot = q_pos[:, 0].long() % W                # per-sequence positions
        if int8_kv:
            (kq, ks), (vq, vs) = L.quantize_kv(k), L.quantize_kv(v)
            kc[rows, slot], vc[rows, slot] = kq[:, 0], vq[:, 0]
            cache["k_scale"][rows, slot] = ks[:, 0]
            cache["v_scale"][rows, slot] = vs[:, 0]
            kc = L.dequantize_kv(kc, cache["k_scale"], q.dtype)
            vc = L.dequantize_kv(vc, cache["v_scale"], q.dtype)
        else:
            kc[rows, slot] = k[:, 0].to(kc.dtype)
            vc[rows, slot] = v[:, 0].to(vc.dtype)
        o = L.attention(cfg, q, kc, vc, q_pos, k_pos, causal=True,
                        window=window)
    else:
        if cache is not None:                        # prefill: write cache
            S = k.shape[1]
            if int8_kv:
                (kq, ks), (vq, vs) = L.quantize_kv(k), L.quantize_kv(v)
                cache["k"][:, :S], cache["v"][:, :S] = kq, vq
                cache["k_scale"][:, :S], cache["v_scale"][:, :S] = ks, vs
            else:
                cache["k"][:, :S] = k
                cache["v"][:, :S] = v
        o = L.attention(cfg, q, k, v, q_pos, q_pos, causal=True,
                        window=window)
    mix = L.attn_out(lp["attn"], o)
    if cfg.parallel_block:                           # command-r
        return x + mix + L.mlp_apply(cfg, lp["mlp"], h)
    x = x + mix
    h2 = L.norm_apply(cfg, lp["norm2"], x)
    return x + L.mlp_apply(cfg, lp["mlp"], h2)


def _layer(params: Params, i: int, dtype: torch.dtype) -> Params:
    """Layer i's parameters, int8 leaves dequantized to ``dtype``."""
    return maybe_dequant(M.tree_map(lambda t: t[i], params["layers"]), dtype)


def _cache_layer(layers: Cache, i: int) -> Cache:
    return {name: t[i] for name, t in layers.items()}


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence forward (no cache): tokens (B, S) -> hidden (B, S, D)."""
    x = embed_tokens(cfg, params, tokens)
    q_pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for i in range(cfg.num_layers):
        x = decoder_block(cfg, _layer(params, i, x.dtype), x, q_pos=q_pos,
                          window=window)
    return L.norm_apply(cfg, params["final_norm"], x)


def lm_logits(cfg: ModelConfig, params: Params,
              hidden: torch.Tensor) -> torch.Tensor:
    """hidden (B, S, D) -> (B, S, V) logits; the embedding is the head
    under ``tie_embeddings``, dequantized to hidden's dtype where int8."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    head = maybe_dequant(head, hidden.dtype)
    if cfg.tie_embeddings:
        head = head.T
    return L.einsum("bsd,dv->bsv", hidden, head)


def classify(cfg: ModelConfig, params: Params,
             hidden: torch.Tensor) -> torch.Tensor:
    """CQ-specific classifier head: mean-pool over the sequence, then
    linear -> (B, num_query_classes) logits, in f32."""
    pooled = torch.mean(hidden.to(torch.float32), dim=1)
    head = maybe_dequant(params["cls_head"], torch.float32)
    return pooled @ head["w"].to(torch.float32) + head["b"].to(torch.float32)


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               dtype: torch.dtype = torch.float32, device="cuda") -> Cache:
    """An empty decode cache on ``device`` (the card unless the caller
    asks for the CPU): ``pos`` (B,) at 0, ``kpos`` (B, W) at -1 (no slot
    written), and per layer K/V (L, B, W, KV, hd) zeros of ``dtype``, in
    the attention's (B, S, KV, hd) layout.  Under ``kv_cache_dtype="int8"``
    K/V are int8, beside f32 ``k_scale``/``v_scale`` (L, B, W, KV): one
    scale per token and KV head."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
             cfg.head_dim)
    int8_kv = cfg.kv_cache_dtype == "int8"
    kv_dt = torch.int8 if int8_kv else dtype
    layers = {"k": torch.zeros(shape, dtype=kv_dt, device=device),
              "v": torch.zeros(shape, dtype=kv_dt, device=device)}
    if int8_kv:
        for name in ("k_scale", "v_scale"):
            layers[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "kpos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                               device=device),
            "layers": layers}


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                token: torch.Tensor, *, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode.  token (B,) -> (logits (B, V), cache).

    ``cache["pos"]`` is per sequence (B,); each row's K/V goes to slot
    ``pos % W`` of its ring.  The layer K/V are written in place; ``pos``
    and ``kpos`` come back as new tensors."""
    pos = cache["pos"]
    B = token.shape[0]
    x = embed_tokens(cfg, params, token[:, None])
    q_pos = pos[:, None].to(torch.int32)                 # (B, 1)
    kpos = cache["kpos"].clone()                         # (B, W)
    rows = torch.arange(B, device=kpos.device)
    kpos[rows, pos.long() % kpos.shape[1]] = pos
    layers = cache["layers"]
    for i in range(cfg.num_layers):
        x = decoder_block(cfg, _layer(params, i, x.dtype), x, q_pos=q_pos,
                          k_pos=kpos, decode=True, window=window,
                          cache=_cache_layer(layers, i))
    x = L.norm_apply(cfg, params["final_norm"], x)
    logits = lm_logits(cfg, params, x)[:, 0]
    return logits, {"pos": pos + 1, "kpos": kpos, "layers": layers}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            cache_len: Optional[int] = None,
            window: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also writes the decode cache.

    tokens (B, S) -> (last position's logits (B, V), a cache of length
    ``max(cache_len, S)`` in the activations' dtype, ready for
    ``decode_step``)."""
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    cache_len = max(cache_len or S, S)
    q_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    cache = make_cache(cfg, B, cache_len, dtype=x.dtype, device=x.device)
    layers = cache["layers"]
    for i in range(cfg.num_layers):
        x = decoder_block(cfg, _layer(params, i, x.dtype), x, q_pos=q_pos,
                          window=window, cache=_cache_layer(layers, i))
    x = L.norm_apply(cfg, params["final_norm"], x)
    logits = lm_logits(cfg, params, x[:, -1:])[:, 0]
    ar = torch.arange(cache_len, dtype=torch.int32, device=x.device)
    kpos = torch.where(ar < S, ar, -1)[None].expand(B, cache_len).clone()
    return logits, {"pos": torch.full((B,), S, dtype=torch.int32,
                                      device=x.device),
                    "kpos": kpos, "layers": layers}


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
