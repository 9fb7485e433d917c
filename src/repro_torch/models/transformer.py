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
int8-weight model computes in bf16.  Three users:

* the pixel path's CQ classifier: ``forward`` + ``classify``, wrapped on
  an explicit device by ``CQClassifier``, which maps (N, T) patch tokens
  to (N,) P(query object) — what ``kernels.ops.score_crops`` calls once a
  tick;
* the serving path (``serving/engine.py``): ``prefill`` writes a decode
  cache and returns the last position's logits, ``decode_step`` decodes
  one token per sequence against it.  Positions are per sequence, so
  slots at different prefix lengths share one decode batch;
* the LLM train step (``train/steps.py``): ``forward`` with ``remat``,
  then ``lm_logits``, differentiated by autograd.

On a device mesh the parameters (and caches) are DTensors placed by
``distributed.sharding``, and every function here takes the reference's
``ctx`` (``sharding.ActCtx``), applied at the reference's call sites:
``ctx(x, "resid")``, ``"act_q"``, ``"moe_buf"``, ``"logits"`` put the
activation in the reference's layout; with ``ctx=None`` nothing changes.

The cache is updated in place (the reference returns a new one): prefill
writes its own fresh cache, and ``decode_step`` writes each layer's new
K/V row, conv window and SSD state into the cache it is given and
returns that same storage, so a caller never holds two copies of a
multi-GB cache.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.cascade import confidence_from_logits
from repro_torch.distributed import quantize as QZ
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import meta as M
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

Params = Dict[str, object]
Cache = Dict[str, object]


def _cf(ctx) -> Callable[[torch.Tensor, str], torch.Tensor]:
    return ctx if ctx is not None else (lambda x, name: x)


def _put_prefix(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[:, :S] = src`` in place: dst (B, W, ...), src (B, S, ...),
    S <= W.  A DTensor ``dst`` whose W axis is split (the
    context-parallel cache) takes, on each shard, the part of the prefix
    that falls in its own range of slots."""
    S = src.shape[1]
    if not SH.is_dtensor(dst):
        dst[:, :S] = src
        return
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in dst.placements]
    # every rank takes part in the redistribution, written to or not
    full = SH.as_dtensor(src, dst.device_mesh).redistribute(
        dst.device_mesh, pl).to_local()
    local = dst.to_local()
    lo = SH.shard_start(dst, 1)
    hi = min(lo + local.shape[1], S)
    if hi > lo:
        local[:, :hi - lo] = full[:, lo:hi].to(local.dtype)


def _put_rows(dst: torch.Tensor, slot: torch.Tensor,
              src: torch.Tensor) -> None:
    """``dst[b, slot[b]] = src[b]`` for every row b, in place: dst (B, W,
    ...), slot (B,) int64, src (B, ...).

    A DTensor ``dst`` is written shard by shard: its local rows take the
    matching rows of ``slot`` and ``src``, and where the ring's W axis is
    split (the context-parallel cache) a shard writes only the slots in
    its own range.  No collective moves the cache."""
    if not SH.is_dtensor(dst):
        rows = torch.arange(dst.shape[0], device=dst.device)
        dst[rows, slot] = src.to(dst.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = dst.device_mesh, dst.placements

    def like(t: torch.Tensor, pls):
        return SH.as_dtensor(t, mesh).redistribute(mesh, pls).to_local()

    batch = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
             for p in pl]
    src_pl = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
              else b for p, b in zip(pl, batch)]
    local = dst.to_local()
    ls = like(slot, batch).long() - SH.shard_start(dst, 1)
    ok = (ls >= 0) & (ls < local.shape[1])
    ls = ls.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    val = like(src, src_pl).to(local.dtype)
    keep = ok.reshape((-1,) + (1,) * (val.ndim - 1))
    local[rows, ls] = torch.where(keep, val, local[rows, ls])


def maybe_dequant(tree, dtype: torch.dtype = torch.bfloat16):
    """Dequantize int8-served weights (``{"q", "s"}`` leaves) to
    ``dtype``; float leaves pass unchanged."""
    return QZ.dequant_tree(tree, dtype)


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    emb = SH.gather_fsdp(params["embed"])
    if isinstance(emb, dict):        # int8-served: gather rows, then scale
        rows = emb["q"][tokens].to(torch.float32)
        return (rows * emb["s"]).to(torch.bfloat16)
    # an embedding lookup (not an index): a vocabulary-sharded DTensor
    # table gives masked partial rows, reduced across the shards here,
    # where indexing would gather the whole table
    return SH.reduce_partial(torch.nn.functional.embedding(tokens, emb))


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
                    window: Optional[int], ctx=None) -> torch.Tensor:
    """Causal self-attention of a decoder layer, its K/V written to the
    cache in place (see ``decoder_block``); returns attn_out."""
    c = _cf(ctx)
    q, k, v = L.qkv_project(cfg, p, h)
    q = c(q, "act_q")
    cos, sin = L.rope_freqs(cfg, q_pos)
    q = L.apply_rope(cfg, q, cos, sin)
    k = L.apply_rope(cfg, k, cos, sin)
    if cfg.kv_cache_dtype not in ("model", "int8"):
        raise NotImplementedError(f"{cfg.name}: kv_cache_dtype "
                                  f"{cfg.kv_cache_dtype!r}")
    int8_kv = cfg.kv_cache_dtype == "int8"
    if decode:
        kc, vc = cache["k"], cache["v"]              # (B, W, KV, hd)
        slot = q_pos[:, 0].long() % kc.shape[1]      # per-sequence positions
        if int8_kv:
            (kq, ks), (vq, vs) = L.quantize_kv(k), L.quantize_kv(v)
            _put_rows(kc, slot, kq[:, 0])
            _put_rows(vc, slot, vq[:, 0])
            _put_rows(cache["k_scale"], slot, ks[:, 0])
            _put_rows(cache["v_scale"], slot, vs[:, 0])
            kc = L.dequantize_kv(kc, cache["k_scale"], q.dtype)
            vc = L.dequantize_kv(vc, cache["v_scale"], q.dtype)
        else:
            _put_rows(kc, slot, k[:, 0])
            _put_rows(vc, slot, v[:, 0])
        o = L.attention(cfg, q, kc, vc, q_pos, k_pos, causal=True,
                        window=window)
    else:
        if cache is not None:                        # prefill: write cache
            S = k.shape[1]
            if int8_kv:
                (kq, ks), (vq, vs) = L.quantize_kv(k), L.quantize_kv(v)
                for name, t in (("k", kq), ("v", vq), ("k_scale", ks),
                                ("v_scale", vs)):
                    _put_prefix(cache[name], t)
            else:
                _put_prefix(cache["k"], k)
                _put_prefix(cache["v"], v)
        o = L.attention(cfg, q, k, v, q_pos, q_pos, causal=True,
                        window=window)
    return L.attn_out(p, c(o, "act_q"))


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
                  enc_out: Optional[torch.Tensor] = None,
                  ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
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
    int8) under ``k_pos`` (B, W), and the SSD state advances a step.
    ``ctx`` constrains q and the attention output ("act_q"), the MLP's
    input and the block's output ("resid"), and the MoE's buffers."""
    c = _cf(ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.norm_apply(cfg, lp["norm1"], x)
    mix = None
    if cfg.has_attn:
        mix = _self_attention(cfg, lp["attn"], h, q_pos=q_pos, k_pos=k_pos,
                              cache=cache, decode=decode, window=window,
                              ctx=ctx)
    if cfg.has_ssm:
        y, (conv, state) = SSM.ssm_block(
            cfg, lp["ssm"], h, conv_cache=cache["conv"] if cache else None,
            ssd_state=cache["ssd"] if cache else None, decode=decode)
        if cache is not None:
            for name, t in conv.items():
                SH.copy_local(cache["conv"][name], t)
            SH.copy_local(cache["ssd"], state)
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
            y, a = L.moe_apply(cfg, lp["moe"], h2, ctx=ctx)
            aux = aux + a
        else:
            y = L.mlp_apply(cfg, lp["mlp"], c(h2, "resid"))
        x = x + y
    return c(x, "resid"), aux


def _layer(tree: Params, i: int, dtype: torch.dtype) -> Params:
    """Layer i's parameters of a stacked tree, their FSDP shards gathered
    (``sharding.gather_fsdp``; DTensor leaves only) and int8 leaves
    dequantized to ``dtype``."""
    return maybe_dequant(SH.gather_fsdp(M.tree_map(lambda t: t[i], tree)),
                         dtype)


def _cache_layer(layers: Cache, i: int) -> Cache:
    """Layer i's slice of the cache: views, so writes land in the cache."""
    return M.tree_map(lambda t: t[i], layers)


def encoder_block(cfg: ModelConfig, lp: Params,
                  x: torch.Tensor, ctx=None) -> torch.Tensor:
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
    return _cf(ctx)(x + L.mlp_apply(cfg, lp["mlp"], h2), "resid")


def _remat_policy(name: str):
    """The selective-checkpoint policy of the reference's
    ``remat_policy``: "dots" saves every matrix-product result
    (``jax.checkpoint_policies.checkpoint_dots``), "dots_no_batch" only
    the products without batch dimensions
    (``checkpoint_dots_with_no_batch_dims``); the rest is recomputed.
    ``torch.einsum`` lowers every product to ``bmm``: one over a batch of
    1 is a product without batch dimensions (the projections'), a larger
    batch has them (attention's scores and values, the experts')."""
    from torch.utils.checkpoint import CheckpointPolicy
    if name not in ("dots", "dots_no_batch"):
        raise ValueError(f"remat_policy={name!r}: expected 'dots', "
                         f"'dots_no_batch' or None")
    aten = torch.ops.aten
    flat = {aten.mm.default, aten.addmm.default}
    batched = {aten.bmm.default: 0, aten.baddbmm.default: 1}

    def saved(op, args) -> bool:
        if op in flat:
            return True
        if op in batched:
            return name == "dots" or args[batched[op]].shape[0] == 1
        return False

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if saved(op, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _rematted(fn: Callable, remat: bool,
              policy: Optional[str] = None) -> Callable:
    """``fn`` itself, or under ``remat`` ``fn`` whose activations are not
    kept for the backward pass but recomputed in it (the analogue of the
    reference's ``jax.checkpoint`` of a scanned layer); a ``policy``
    keeps the results it names (``_remat_policy``)."""
    if not remat:
        return fn
    kw = {}
    if policy is not None:
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _remat_policy(policy))
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False, **kw)


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor,
           remat: bool = False, ctx=None) -> torch.Tensor:
    """frames (B, Se, D), the stubbed conv frontend's output -> the
    encoder's (B, Se, D): sinusoid positions, the encoder stack, its
    final norm.  ``remat`` recomputes each layer in the backward pass."""
    pos = sinusoid_pos(torch.arange(frames.shape[1], device=frames.device),
                       cfg.d_model)
    x = frames + pos[None].to(frames.dtype)

    def layer(x, i):
        return encoder_block(cfg, _layer(params["enc_layers"], i, x.dtype), x,
                             ctx=ctx)

    layer = _rematted(layer, remat)
    for i in range(cfg.num_enc_layers):
        x = layer(x, i)
    return L.norm_apply(cfg, SH.gather_fsdp(params["enc_norm"]), x)


def _inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            img_embeds: Optional[torch.Tensor],
            audio_frames: Optional[torch.Tensor], remat: bool = False,
            ctx=None):
    """The trunk's input (B, S_tot, D) and the encoder's output (or None):
    token embeddings behind the projected image prefix (vlm), plus
    sinusoid positions under an encoder (audio)."""
    x = embed_tokens(cfg, params, tokens)
    if cfg.num_img_tokens > 0:
        if img_embeds is None:
            raise ValueError(f"{cfg.name} takes img_embeds (B, "
                             f"{cfg.num_img_tokens}, 1024)")
        pe = L.einsum("bnv,vd->bnd", img_embeds,
                      maybe_dequant(SH.gather_fsdp(params["img_proj"]),
                                    x.dtype))
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    enc_out = None
    if cfg.is_encdec:
        if audio_frames is None:
            raise ValueError(f"{cfg.name} takes audio_frames (B, enc_seq, "
                             f"{cfg.d_model})")
        enc_out = encode(cfg, params, audio_frames, remat=remat, ctx=ctx)
        x = x + sinusoid_pos(torch.arange(x.shape[1], device=x.device),
                             cfg.d_model)[None].to(x.dtype)
    return x, enc_out


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            img_embeds: Optional[torch.Tensor] = None,
            audio_frames: Optional[torch.Tensor] = None,
            window: Optional[int] = None,
            remat: bool = False,
            remat_policy: Optional[str] = None,
            ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (no cache): tokens (B, S) -> (hidden (B,
    S_tot, D), the summed MoE aux loss); S_tot counts the image prefix.

    ``remat`` (training) keeps no layer's activations for the backward
    pass: each decoder and encoder layer runs under
    ``torch.utils.checkpoint`` and is recomputed there, so the gradients
    are those without it.  ``remat_policy`` ("dots", "dots_no_batch";
    decoder layers only, as the reference's) saves matrix products from
    the recomputation (selective activation checkpointing): it changes
    what is kept, never the numbers.  ``ctx`` is applied to the trunk's
    input and through every layer."""
    if remat_policy is not None:
        _remat_policy(remat_policy)          # an unknown name raises
    x, enc_out = _inputs(cfg, params, tokens, img_embeds, audio_frames,
                         remat=remat, ctx=ctx)
    x = _cf(ctx)(x, "resid")
    q_pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def layer(x, i):
        return decoder_block(cfg, _layer(params["layers"], i, x.dtype), x,
                             q_pos=q_pos, window=window, enc_out=enc_out,
                             ctx=ctx)

    layer = _rematted(layer, remat, remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a = layer(x, i)
        aux = aux + a
    return L.norm_apply(cfg, SH.gather_fsdp(params["final_norm"]), x), aux


def lm_logits(cfg: ModelConfig, params: Params,
              hidden: torch.Tensor, ctx=None) -> torch.Tensor:
    """hidden (B, S, D) -> (B, S, V) logits; the embedding is the head
    under ``tie_embeddings``, dequantized to hidden's dtype where int8."""
    head = SH.gather_fsdp(params["embed"] if cfg.tie_embeddings
                          else params["lm_head"])
    head = maybe_dequant(head, hidden.dtype)
    if cfg.tie_embeddings:
        head = head.T
    return _cf(ctx)(L.einsum("bsd,dv->bsv", hidden, head), "logits")


def classify(cfg: ModelConfig, params: Params,
             hidden: torch.Tensor) -> torch.Tensor:
    """CQ-specific classifier head: mean-pool over the sequence, then
    linear -> (B, num_query_classes) logits, in f32."""
    pooled = torch.mean(hidden.to(torch.float32), dim=1)
    head = maybe_dequant(SH.gather_fsdp(params["cls_head"]), torch.float32)
    return pooled @ head["w"].to(torch.float32) + head["b"].to(torch.float32)


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               dtype: torch.dtype = torch.float32, device=None,
               abstract: bool = False) -> Cache:
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
    * encoder-decoder: ``cross_k``/``cross_v`` (L, B, enc_seq, KV, hd).

    ``abstract`` gives the same tree as storage-free tensors on the
    ``meta`` device (or, under a ``FakeTensorMode``, fake ones on
    ``device``): the dry-run's stand-in for ShapeDtypeStructs."""
    if abstract:
        device = torch.device("meta" if device is None else device)
    else:
        device = resolve_device("cuda" if device is None else device)
    Lc, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zeros(shape, dt=dtype):
        if abstract:
            return torch.empty(shape, dtype=dt, device=device)
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
    kpos = zeros((batch, cache_len), torch.int32)
    if not abstract and cfg.has_attn:
        kpos.fill_(-1)
    return {"pos": zeros((batch,), torch.int32), "kpos": kpos,
            "layers": layers}


def _new_cache(cfg: ModelConfig, batch: int, cache_len: int,
               x: torch.Tensor, ctx) -> Cache:
    """A prefill's empty cache in ``x``'s dtype on its device: plain, or,
    where ``x`` is a DTensor on ``ctx``'s mesh, DTensors laid out by
    ``sharding.cache_specs``, each rank allocating its own shard."""
    if not (SH.is_dtensor(x) and hasattr(ctx, "mesh")):
        return make_cache(cfg, batch, cache_len, dtype=x.dtype,
                          device=x.device)
    abstract = make_cache(cfg, batch, cache_len, dtype=x.dtype,
                          abstract=True)
    specs = SH.cache_specs(cfg, ctx.mesh, batch, abstract)

    def place(t, sh, name=""):
        if isinstance(t, dict):
            return {k: place(t[k], sh[k], k) for k in t}
        fill = -1 if name == "kpos" and cfg.has_attn else 0
        local = torch.full(sh.local_shape(t.shape), fill, dtype=t.dtype,
                           device=x.device)
        return SH.from_local(local, sh, t.shape)
    return place(abstract, specs)


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                token: torch.Tensor, *, window: Optional[int] = None,
                ctx=None) -> Tuple[torch.Tensor, Cache]:
    """One-token decode.  token (B,) -> (logits (B, V), cache).

    ``cache["pos"]`` is per sequence (B,); each row's K/V goes to slot
    ``pos % W`` of its ring, and ``kpos`` is updated only where the model
    has attention.  The layer caches are written in place; ``pos`` (and
    ``kpos``, where updated) come back as new tensors."""
    c = _cf(ctx)
    pos = cache["pos"]
    x = embed_tokens(cfg, params, token[:, None])
    if cfg.is_encdec:
        x = x + sinusoid_pos(pos, cfg.d_model)[:, None].to(x.dtype)
    x = c(x, "resid")
    q_pos = pos[:, None].to(torch.int32)                 # (B, 1)
    kpos = cache["kpos"]                                 # (B, W)
    if cfg.has_attn:
        kpos = kpos.clone()
        _put_rows(kpos, pos.long() % kpos.shape[1], pos)
    layers = cache["layers"]
    for i in range(cfg.num_layers):
        x, _ = decoder_block(cfg, _layer(params["layers"], i, x.dtype), x,
                             q_pos=q_pos, k_pos=kpos, decode=True,
                             window=window, cache=_cache_layer(layers, i),
                             ctx=ctx)
    x = L.norm_apply(cfg, SH.gather_fsdp(params["final_norm"]), x)
    logits = lm_logits(cfg, params, x, ctx=ctx)[:, 0]
    return logits, {"pos": pos + 1, "kpos": kpos, "layers": layers}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            cache_len: Optional[int] = None,
            audio_frames: Optional[torch.Tensor] = None,
            img_embeds: Optional[torch.Tensor] = None,
            window: Optional[int] = None,
            ctx=None) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also writes the decode cache.

    tokens (B, S) -> (last position's logits (B, V), a cache in the
    activations' dtype, ready for ``decode_step``).  The cache holds
    ``max(cache_len, S_tot)`` positions, where ``cache_len`` counts text
    positions and gains the image prefix's ``num_img_tokens`` (S_tot
    counts them too); its cross-attention K/V hold ``enc_seq`` frames."""
    B = tokens.shape[0]
    x, enc_out = _inputs(cfg, params, tokens, img_embeds, audio_frames,
                         ctx=ctx)
    S = x.shape[1]
    if cache_len is not None and cfg.num_img_tokens:
        cache_len += cfg.num_img_tokens
    cache_len = max(cache_len or S, S)
    q_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    cache = _new_cache(cfg, B, cache_len, x, ctx)
    layers = cache["layers"]
    for i in range(cfg.num_layers):
        x, _ = decoder_block(cfg, _layer(params["layers"], i, x.dtype), x,
                             q_pos=q_pos, window=window, enc_out=enc_out,
                             cache=_cache_layer(layers, i), ctx=ctx)
    x = L.norm_apply(cfg, SH.gather_fsdp(params["final_norm"]), x)
    logits = lm_logits(cfg, params, x[:, -1:], ctx=ctx)[:, 0]
    ar = torch.arange(cache_len, dtype=torch.int32, device=x.device)
    kpos = torch.where(ar < S, ar, -1)[None].expand(B, cache_len).clone()
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    if SH.is_dtensor(layers[next(iter(layers))]):
        specs = SH.cache_specs(cfg, ctx.mesh, B, {"pos": pos, "kpos": kpos})
        pos = SH.distribute(pos, specs["pos"])
        kpos = SH.distribute(kpos, specs["kpos"])
    return logits, {"pos": pos, "kpos": kpos, "layers": layers}


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
