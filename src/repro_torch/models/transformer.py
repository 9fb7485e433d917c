"""Trunk of every model family: token embedding (with internvl2's image
prefix), the encoder (whisper), decoder blocks, final norm, the LM and
classification heads, and the prefill/decode cache.

The reference's ``models/transformer.py`` in PyTorch.  One
``decoder_block`` covers the six families through config flags:

  dense   attention + MLP (sequential, or command-r's parallel block)
  moe     attention + sort-dispatched MoE       (granite-moe, phi3.5-moe)
  ssm     the Mamba-2 mixer only                (mamba2)
  hybrid  attention and SSM heads averaged, + MLP (hymba)
  audio   encoder-decoder with cross-attention  (whisper; frames stubbed)
  vlm     dense + an image-embedding prefix     (internvl2; ViT stubbed)

The reference scans stacked layer parameters with ``lax.scan``; here a
Python loop over layers indexes the same stacked tensors.  Weights may be
served in int8 (``distributed.quantize.quantize_tree``): the loop
dequantizes one layer's slice at a time (``maybe_dequant``) in the
activations' dtype, and the embedding's int8 rows come out in bf16, so an
int8-weight model computes in bf16.  Two users:

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
K/V row, conv window and SSD state into the cache it is given and
returns that same storage, so a caller never holds two copies of a
multi-GB cache.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.cascade import confidence_from_logits
from repro_torch.distributed import quantize as QZ
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import meta as M
from repro_torch.models import ssm as SSM
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


def sinusoid_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S,) int positions -> (S, d) f32 [sin | cos] absolute positions."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[:, None].to(torch.float32) * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _self_attention(cfg: ModelConfig, p, h: torch.Tensor, *,
                    q_pos: torch.Tensor, k_pos: Optional[torch.Tensor],
                    cache: Optional[Cache], decode: bool,
                    window: Optional[int]) -> torch.Tensor:
    """Causal self-attention of a decoder layer, its K/V written to the
    cache in place (see ``decoder_block``); returns attn_out."""
    q, k, v = L.qkv_project(cfg, p, h)
    cos, sin = L.rope_freqs(cfg, q_pos)
    q = L.apply_rope(cfg, q, cos, sin)
    k = L.apply_rope(cfg, k, cos, sin)
    if cfg.kv_cache_dtype not in ("model", "int8"):
        raise NotImplementedError(f"{cfg.name}: kv_cache_dtype "
                                  f"{cfg.kv_cache_dtype!r}")
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
    return L.attn_out(p, o)


def _cross_attention(cfg: ModelConfig, p, hc: torch.Tensor, *,
                     q_pos: torch.Tensor, cache: Optional[Cache],
                     decode: bool, enc_out: Optional[torch.Tensor]
                     ) -> torch.Tensor:
    """Non-causal attention of the decoder over the encoder's output.  A
    prefill projects ``enc_out`` to K/V (no RoPE, no qk-norm) and writes
    them to the cache's ``cross_k``/``cross_v``; decode reads them back."""
    q = L.einsum("bsd,dhk->bshk", hc, p["wq"])
    if cfg.attn_bias:
        q = q + p["bq"]
    if decode or enc_out is None:
        ck, cv = cache["cross_k"], cache["cross_v"]  # (B, Se, KV, hd)
    else:
        ck = L.einsum("bsd,dhk->bshk", enc_out, p["wk"])
        cv = L.einsum("bsd,dhk->bshk", enc_out, p["wv"])
        if cfg.attn_bias:
            ck, cv = ck + p["bk"], cv + p["bv"]
        if cache is not None:
            cache["cross_k"].copy_(ck)
            cache["cross_v"].copy_(cv)
    e_pos = torch.arange(ck.shape[1], dtype=torch.int32, device=ck.device)
    o = L.attention(cfg, q, ck, cv, q_pos, e_pos, causal=False)
    return L.einsum("bshk,hkd->bsd", o, p["wo"])


def decoder_block(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
                  q_pos: torch.Tensor,
                  k_pos: Optional[torch.Tensor] = None,
                  cache: Optional[Cache] = None, decode: bool = False,
                  window: Optional[int] = None,
                  enc_out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer; returns (x, aux), aux the MoE's load-balance
    loss (0 without MoE).

    The mixer reads h = norm1(x): causal self-attention (every family but
    mamba2), the Mamba-2 SSM (mamba2, and hymba, which averages it with
    attention 0.5/0.5), or both.  Then x + mix; under ``parallel_block``
    (command-r) x + mix + mlp(h) from the one norm and nothing more.
    Otherwise cross-attention over the encoder (whisper), then x + MoE or
    MLP of norm2(x).

    Without ``decode``: attention over the sequence itself; with a
    ``cache`` (a layer's slice of ``make_cache``) the rotated K and V go,
    in place, to its first S positions (int8 values and their scales
    under ``kv_cache_dtype="int8"``, while attention reads the unquantized
    K/V), the conv windows and the final SSD state replace the cache's,
    and cross-attention writes its K/V.  With ``decode``: x is one token
    per row at ``q_pos`` (B, 1); its K/V go to slot ``q_pos % W`` of row
    b, attention reads the whole cache (dequantized to q's dtype under
    int8) under ``k_pos`` (B, W), and the SSD state advances a step."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.norm_apply(cfg, lp["norm1"], x)
    mix = None
    if cfg.has_attn:
        mix = _self_attention(cfg, lp["attn"], h, q_pos=q_pos, k_pos=k_pos,
                              cache=cache, decode=decode, window=window)
    if cfg.has_ssm:
        y, (conv, state) = SSM.ssm_block(
            cfg, lp["ssm"], h, conv_cache=cache["conv"] if cache else None,
            ssd_state=cache["ssd"] if cache else None, decode=decode)
        if cache is not None:
            for name, t in conv.items():
                cache["conv"][name].copy_(t)
            cache["ssd"].copy_(state)
        mix = y if mix is None else 0.5 * (mix + y)  # hymba: parallel heads
    if cfg.parallel_block and cfg.d_ff > 0:          # command-r
        return x + mix + L.mlp_apply(cfg, lp["mlp"], h), aux
    x = x + mix
    if cfg.is_encdec:
        hc = L.norm_apply(cfg, lp["norm_cross"], x)
        x = x + _cross_attention(cfg, lp["cross"], hc, q_pos=q_pos,
                                 cache=cache, decode=decode, enc_out=enc_out)
    if cfg.d_ff > 0:
        h2 = L.norm_apply(cfg, lp["norm2"], x)
        if cfg.is_moe:
            y, a = L.moe_apply(cfg, lp["moe"], h2)
            aux = aux + a
        else:
            y = L.mlp_apply(cfg, lp["mlp"], h2)
        x = x + y
    return x, aux


def _layer(tree: Params, i: int, dtype: torch.dtype) -> Params:
    """Layer i's parameters of a stacked tree, int8 leaves dequantized to
    ``dtype``."""
    return maybe_dequant(M.tree_map(lambda t: t[i], tree), dtype)


def _cache_layer(layers: Cache, i: int) -> Cache:
    """Layer i's slice of the cache: views, so writes land in the cache."""
    return M.tree_map(lambda t: t[i], layers)


def encoder_block(cfg: ModelConfig, lp: Params,
                  x: torch.Tensor) -> torch.Tensor:
    """One encoder layer: bidirectional attention (no RoPE, no qk-norm:
    the chunked path) and the MLP, each pre-normed."""
    h = L.norm_apply(cfg, lp["norm1"], x)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    p = lp["attn"]
    q = L.einsum("bsd,dhk->bshk", h, p["wq"])
    k = L.einsum("bsd,dhk->bshk", h, p["wk"])
    v = L.einsum("bsd,dhk->bshk", h, p["wv"])
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    o = L.attention(cfg, q, k, v, pos, pos, causal=False)
    x = x + L.attn_out(p, o)
    h2 = L.norm_apply(cfg, lp["norm2"], x)
    return x + L.mlp_apply(cfg, lp["mlp"], h2)


def encode(cfg: ModelConfig, params: Params,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, Se, D), the stubbed conv frontend's output -> the
    encoder's (B, Se, D): sinusoid positions, the encoder stack, its
    final norm."""
    pos = sinusoid_pos(torch.arange(frames.shape[1], device=frames.device),
                       cfg.d_model)
    x = frames + pos[None].to(frames.dtype)
    for i in range(cfg.num_enc_layers):
        x = encoder_block(cfg, _layer(params["enc_layers"], i, x.dtype), x)
    return L.norm_apply(cfg, params["enc_norm"], x)


def _inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            img_embeds: Optional[torch.Tensor],
            audio_frames: Optional[torch.Tensor]):
    """The trunk's input (B, S_tot, D) and the encoder's output (or None):
    token embeddings behind the projected image prefix (vlm), plus
    sinusoid positions under an encoder (audio)."""
    x = embed_tokens(cfg, params, tokens)
    if cfg.num_img_tokens > 0:
        if img_embeds is None:
            raise ValueError(f"{cfg.name} takes img_embeds (B, "
                             f"{cfg.num_img_tokens}, 1024)")
        pe = L.einsum("bnv,vd->bnd", img_embeds,
                      maybe_dequant(params["img_proj"], x.dtype))
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    enc_out = None
    if cfg.is_encdec:
        if audio_frames is None:
            raise ValueError(f"{cfg.name} takes audio_frames (B, enc_seq, "
                             f"{cfg.d_model})")
        enc_out = encode(cfg, params, audio_frames)
        x = x + sinusoid_pos(torch.arange(x.shape[1], device=x.device),
                             cfg.d_model)[None].to(x.dtype)
    return x, enc_out


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            img_embeds: Optional[torch.Tensor] = None,
            audio_frames: Optional[torch.Tensor] = None,
            window: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (no cache): tokens (B, S) -> (hidden (B,
    S_tot, D), the summed MoE aux loss); S_tot counts the image prefix."""
    x, enc_out = _inputs(cfg, params, tokens, img_embeds, audio_frames)
    q_pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a = decoder_block(cfg, _layer(params["layers"], i, x.dtype), x,
                             q_pos=q_pos, window=window, enc_out=enc_out)
        aux = aux + a
    return L.norm_apply(cfg, params["final_norm"], x), aux


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
    asks for the CPU): ``pos`` (B,) at 0 and ``kpos`` (B, W), -1 (no slot
    written) where the model has attention; per layer, stacked over the
    L layers:

    * attention: K/V (L, B, W, KV, hd) zeros of ``dtype``, in the
      attention's (B, S, KV, hd) layout; under ``kv_cache_dtype="int8"``
      int8 K/V beside f32 ``k_scale``/``v_scale`` (L, B, W, KV);
    * SSM: the conv windows ``conv`` ``{"x", "b", "c"}`` (L, B, conv-1,
      channels) of ``dtype`` and the SSD state ``ssd`` (L, B, nh, hd, N)
      in f32;
    * encoder-decoder: ``cross_k``/``cross_v`` (L, B, enc_seq, KV, hd)."""
    device = resolve_device(device)
    Lc, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    layers: Cache = {}
    if cfg.has_attn:
        int8_kv = cfg.kv_cache_dtype == "int8"
        shape = (Lc, batch, cache_len, KV, hd)
        layers["k"] = zeros(shape, torch.int8 if int8_kv else dtype)
        layers["v"] = zeros(shape, torch.int8 if int8_kv else dtype)
        if int8_kv:
            layers["k_scale"] = zeros(shape[:-1], torch.float32)
            layers["v_scale"] = zeros(shape[:-1], torch.float32)
    if cfg.has_ssm:
        W, GN = cfg.ssm_conv, cfg.ssm_ngroups * cfg.ssm_state
        layers["conv"] = {"x": zeros((Lc, batch, W - 1, cfg.ssm_d_inner)),
                          "b": zeros((Lc, batch, W - 1, GN)),
                          "c": zeros((Lc, batch, W - 1, GN))}
        layers["ssd"] = zeros((Lc, batch, cfg.ssm_heads, cfg.ssm_headdim,
                               cfg.ssm_state), torch.float32)
    if cfg.is_encdec:
        layers["cross_k"] = zeros((Lc, batch, cfg.enc_seq, KV, hd))
        layers["cross_v"] = zeros((Lc, batch, cfg.enc_seq, KV, hd))
    return {"pos": zeros((batch,), torch.int32),
            "kpos": torch.full((batch, cache_len), -1 if cfg.has_attn else 0,
                               dtype=torch.int32, device=device),
            "layers": layers}


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                token: torch.Tensor, *, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode.  token (B,) -> (logits (B, V), cache).

    ``cache["pos"]`` is per sequence (B,); each row's K/V goes to slot
    ``pos % W`` of its ring, and ``kpos`` is updated only where the model
    has attention.  The layer caches are written in place; ``pos`` (and
    ``kpos``, where updated) come back as new tensors."""
    pos = cache["pos"]
    B = token.shape[0]
    x = embed_tokens(cfg, params, token[:, None])
    if cfg.is_encdec:
        x = x + sinusoid_pos(pos, cfg.d_model)[:, None].to(x.dtype)
    q_pos = pos[:, None].to(torch.int32)                 # (B, 1)
    kpos = cache["kpos"]                                 # (B, W)
    if cfg.has_attn:
        kpos = kpos.clone()
        rows = torch.arange(B, device=kpos.device)
        kpos[rows, pos.long() % kpos.shape[1]] = pos
    layers = cache["layers"]
    for i in range(cfg.num_layers):
        x, _ = decoder_block(cfg, _layer(params["layers"], i, x.dtype), x,
                             q_pos=q_pos, k_pos=kpos, decode=True,
                             window=window, cache=_cache_layer(layers, i))
    x = L.norm_apply(cfg, params["final_norm"], x)
    logits = lm_logits(cfg, params, x)[:, 0]
    return logits, {"pos": pos + 1, "kpos": kpos, "layers": layers}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            cache_len: Optional[int] = None,
            audio_frames: Optional[torch.Tensor] = None,
            img_embeds: Optional[torch.Tensor] = None,
            window: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also writes the decode cache.

    tokens (B, S) -> (last position's logits (B, V), a cache in the
    activations' dtype, ready for ``decode_step``).  The cache holds
    ``max(cache_len, S_tot)`` positions, where ``cache_len`` counts text
    positions and gains the image prefix's ``num_img_tokens`` (S_tot
    counts them too); its cross-attention K/V hold ``enc_seq`` frames."""
    B = tokens.shape[0]
    x, enc_out = _inputs(cfg, params, tokens, img_embeds, audio_frames)
    S = x.shape[1]
    if cache_len is not None and cfg.num_img_tokens:
        cache_len += cfg.num_img_tokens
    cache_len = max(cache_len or S, S)
    q_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    cache = make_cache(cfg, B, cache_len, dtype=x.dtype, device=x.device)
    layers = cache["layers"]
    for i in range(cfg.num_layers):
        x, _ = decoder_block(cfg, _layer(params["layers"], i, x.dtype), x,
                             q_pos=q_pos, window=window, enc_out=enc_out,
                             cache=_cache_layer(layers, i))
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
        self.cfg = cfg
        self.device = resolve_device(device)
        self.query_class = query_class
        self.params = M.tree_map(lambda t: t.to(self.device), params)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        h, _ = forward(self.cfg, self.params, tokens.to(self.device))
        return confidence_from_logits(classify(self.cfg, self.params, h),
                                      self.query_class)
