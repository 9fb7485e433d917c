"""Roofline analysis of every (arch x shape x mesh) step.

Three terms, in seconds per step, over the H100 SXM5's spec-sheet
constants (``launch.mesh``):

  compute    = FLOPs            / (chips x 989.4e12 bf16 FLOP/s)
  memory     = HBM bytes        / (chips x 3.35e12  B/s)
  collective = collective bytes / (chips x 50e9     B/s per GPU link)

The FLOP and byte counts are the reference's formulas, unchanged (exact
matmul/state-update accounting from the config and the sharding design);
only the seconds differ, by the ratio of the constants.  Beside them, the
dry-run's record (``launch.dryrun``): its per-device FLOPs, counted on
the local shards, times the chips, and its collective bytes.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

from repro_torch.configs.shapes import (InputShape, attn_cache_len,
                                        decode_window)
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.config import ModelConfig

BYTES = 2          # bf16


# --- analytic FLOPs -------------------------------------------------------------

def flops_per_token(cfg: ModelConfig, ctx_len: int,
                    window: Optional[int] = None) -> float:
    """Forward matmul FLOPs for ONE token with `ctx_len` visible context."""
    D, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    eff_ctx = min(ctx_len, window) if window else ctx_len
    per_layer = 0.0
    if cfg.has_attn:
        per_layer += 2 * D * (H + 2 * KV) * hd          # qkv proj
        per_layer += 2 * H * hd * D                     # out proj
        per_layer += 4 * eff_ctx * H * hd               # qk^T + pv
    if cfg.has_ssm:
        d_in, nh, G, N = (cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_ngroups,
                          cfg.ssm_state)
        per_layer += 2 * D * (2 * d_in + 2 * G * N + nh)   # in projs
        per_layer += 2 * cfg.ssm_conv * (d_in + 2 * G * N)  # conv
        per_layer += 6 * nh * hd_ssm(cfg) * N              # state upd + out
        per_layer += 2 * d_in * D                          # out proj
    if cfg.d_ff > 0:
        gate = 3 if cfg.mlp_act == "silu" else 2
        e = cfg.top_k if cfg.is_moe else 1
        per_layer += 2 * gate * D * cfg.d_ff * e
        if cfg.is_moe:
            per_layer += 2 * D * cfg.num_experts        # router
    total = cfg.num_layers * per_layer
    total += 2 * D * cfg.vocab_size                     # lm head
    if cfg.is_encdec:
        # cross attention per decoder layer
        total += cfg.num_layers * (4 * D * H * hd + 4 * cfg.enc_seq * H * hd)
    return total


def hd_ssm(cfg: ModelConfig) -> int:
    return cfg.ssm_headdim


def encoder_flops(cfg: ModelConfig, batch: int) -> float:
    if not cfg.is_encdec:
        return 0.0
    D, H, hd, S = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.enc_seq
    per_layer = 8 * D * H * hd + 4 * S * H * hd + 4 * D * cfg.d_ff
    return batch * S * cfg.num_enc_layers * per_layer


def analytic_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Global FLOPs for one step of this (cfg, shape)."""
    B, S = shape.global_batch, shape.seq_len
    w = decode_window(cfg, shape)
    if shape.kind == "decode":
        return B * flops_per_token(cfg, S, w) + encoder_flops(cfg, 0)
    # prefill/train: sum over positions of causal context ~ S/2 average
    avg_ctx = (S + 1) / 2
    fwd = B * S * flops_per_token(cfg, avg_ctx, w) + encoder_flops(cfg, B)
    return 3 * fwd if shape.kind == "train" else fwd


def decode_flops_per_device(cfg: ModelConfig, shape: InputShape,
                            data: int, tp: int) -> float:
    """The matrix-product FLOPs of one decode step on one device of a
    mesh with ``data`` batch shards and a ``tp``-way "model" axis:
    ``flops_per_token``'s terms for the rows the device holds, each over
    the shards that split it under the sharding rules (a dimension splits
    where ``tp`` divides it; attention over the cache splits with the KV
    heads, else with the cache's slots: the context-parallel layout).
    Three terms differ from the reference's count, each as the port
    computes it: the SSD's state update and the depthwise convs are
    elementwise, which ``torch.utils.flop_counter`` does not count, so of
    the SSD only its output product C.h (2 nh hd N, not 6) is kept and
    the convs are left out; and the MoE's experts run over their
    capacity slots (E x ``moe_capacity`` a row) where the reference
    counts top_k a token."""
    from repro_torch.models.layers import moe_capacity
    if shape.kind != "decode":
        raise ValueError(f"{shape.name}: a decode shape, not {shape.kind}")

    def split(n: int) -> int:
        return tp if n % tp == 0 and n > 1 else 1

    B = shape.global_batch
    rows = B // data if B % data == 0 else B
    D, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    ctx = attn_cache_len(cfg, shape)
    per_layer = 0.0
    if cfg.has_attn:
        per_layer += 2 * D * H * hd / split(H) + 4 * D * KV * hd / split(KV)
        per_layer += 2 * H * hd * D / split(H)
        over = split(KV) if split(KV) > 1 else split(ctx) \
            if split(ctx) > 1 else split(H)
        per_layer += 4 * ctx * H * hd / over
    if cfg.has_ssm:
        d_in, nh, G, N = (cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_ngroups,
                          cfg.ssm_state)
        ssd = split(nh) if split(nh) > 1 else split(hd_ssm(cfg))
        per_layer += 4 * D * d_in / split(d_in) + 4 * D * G * N
        per_layer += 2 * D * nh / split(nh)
        per_layer += 2 * nh * hd_ssm(cfg) * N / ssd
        per_layer += 2 * d_in * D / split(d_in)
    if cfg.d_ff > 0:
        gate = 3 if cfg.mlp_act == "silu" else 2
        if cfg.is_moe:
            slots = cfg.num_experts * moe_capacity(cfg, 1)
            per_layer += 2 * gate * D * cfg.d_ff * slots / split(
                cfg.num_experts)
            per_layer += 2 * D * cfg.num_experts
        else:
            per_layer += 2 * gate * D * cfg.d_ff / split(cfg.d_ff)
    total = cfg.num_layers * per_layer + 2 * D * cfg.vocab_size / split(
        cfg.vocab_size)
    if cfg.is_encdec:
        Se = cfg.enc_seq
        over = split(KV) if split(KV) > 1 else split(Se) \
            if split(Se) > 1 else split(H)
        total += cfg.num_layers * (4 * D * H * hd / split(H)
                                   + 4 * Se * H * hd / over)
    return rows * total


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """The 6·N·D convention (active params for MoE)."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "decode":
        tokens = shape.global_batch
        return 2 * n * tokens            # fwd only
    tokens = shape.global_batch * shape.seq_len
    return (6 if shape.kind == "train" else 2) * n * tokens


# --- analytic HBM bytes -----------------------------------------------------------

def analytic_hbm_bytes(cfg: ModelConfig, shape: InputShape, chips: int,
                       two_d_serve: bool) -> float:
    """Per-chip HBM traffic per step x chips (global bytes)."""
    params_b = cfg.param_count() * BYTES
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, cfg.num_layers
    if shape.kind == "decode":
        cache_len = attn_cache_len(cfg, shape)
        cache_b = 0.0
        if cfg.has_attn:
            cache_b += 2 * L * B * cache_len * cfg.num_kv_heads * cfg.head_dim * BYTES
        if cfg.has_ssm:
            cache_b += L * B * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
        if cfg.is_encdec:
            cache_b += 2 * L * B * cfg.enc_seq * cfg.num_kv_heads * cfg.head_dim * BYTES
        # every decode step reads all (sharded) weights + reads cache + writes
        # the new slot (~read-dominated)
        return params_b + cache_b + B * D * L * BYTES * 8
    tokens = B * S
    act = tokens * D * L * BYTES * 12          # activations r/w along the stack
    weights = params_b * (3 if shape.kind == "train" else 1)
    if shape.kind == "train":
        weights += cfg.param_count() * 4 * 3   # f32 m, v read+write + grads
    return weights + act


# --- analytic collective bytes ------------------------------------------------------

def analytic_collective_bytes(cfg: ModelConfig, shape: InputShape,
                              data_shards: int, tp: int,
                              two_d_serve: bool, microbatches: int) -> float:
    """Global bytes crossing the links per step, from the sharding design:

      train:  grad reduce-scatter + FSDP weight all-gathers (fwd+bwd)
              + TP/seq-parallel activation collectives per layer
      serve:  TP all-reduces per layer (+ 2-D weight gathers if enabled)
      moe:    all-to-all of dispatched tokens, both directions
    """
    params_b = cfg.param_count() * BYTES
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, cfg.num_layers
    tokens = B * S if shape.kind != "decode" else B
    coll = 0.0
    if shape.kind == "train":
        coll += 2 * params_b                      # grad RS + param AG (FSDP)
        coll += 2 * params_b * microbatches       # weight AG per microbatch fwd+bwd
        coll += 4 * tokens * D * BYTES * L        # seq-par <-> TP boundary per layer
    else:
        passes = 1
        coll += 2 * tokens * D * BYTES * L        # TP all-reduce fwd per layer
        if two_d_serve:
            coll += params_b / tp * passes        # 2-D weight all-gather per chip row
    if cfg.is_moe:
        coll += 2 * tokens * cfg.top_k * D * BYTES * (2 if shape.kind == "train" else 1)
    return coll


# --- assembly -------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    analytic_flops: float
    compiled_flops: float
    compiled_coll_bytes: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.analytic_flops, 1.0)


def analyze(cfg: ModelConfig, shape: InputShape, *, chips: int = 256,
            tp: int = 16, mesh_name: str = "single",
            dryrun_record: Optional[Dict[str, Any]] = None) -> Roofline:
    data_shards = chips // tp
    two_d = cfg.param_count() * BYTES / tp > 2e9
    micro = 1
    if shape.kind == "train":
        from repro_torch.train.steps import default_microbatches
        micro = default_microbatches(cfg, shape.global_batch, data_shards)
    fl = analytic_flops(cfg, shape)
    hbm = analytic_hbm_bytes(cfg, shape, chips, two_d)
    coll = analytic_collective_bytes(cfg, shape, data_shards, tp, two_d, micro)
    rec = dryrun_record or {}
    compiled_fl = float(rec.get("cost", {}).get("flops", 0.0)) * chips
    compiled_coll = float(rec.get("collectives", {}).get("total_bytes", 0.0))
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        compute_s=fl / (chips * PEAK_FLOPS_BF16),
        memory_s=hbm / (chips * HBM_BW),
        collective_s=coll / (chips * LINK_BW),
        model_flops=model_flops(cfg, shape),
        analytic_flops=fl,
        compiled_flops=compiled_fl,
        compiled_coll_bytes=compiled_coll,
    )


# --- pixel-cascade kernels ------------------------------------------------------------

#: int32 element size of the pixel kernels' frames and masks
PIXEL_BYTES = 4

#: approximate integer ops per pixel for each pixel-cascade stage:
#: framediff = 3ch x (2 sub/abs + and) + 3 mul + 2 add + 1 div + 1 cmp/select;
#: each 3x3 morphology stage = 8 max/min reductions
PIXEL_FLOPS = {"framediff": 16.0, "dilate": 8.0, "erode": 8.0}


@dataclasses.dataclass
class PixelRoofline:
    """Analytic bytes/FLOPs roofline for one pixel-frontend variant.

    ``roofline_fraction`` is the fraction of peak compute the kernel's
    arithmetic intensity admits on the H100's spec-sheet roofline
    (min(1, AI / ridge), ridge = peak FLOP/s over HBM B/s) — below 1.0
    the kernel is bandwidth-bound and bytes, not launches, are the cost.
    """
    name: str
    hbm_bytes: float
    flops: float

    @property
    def ai(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)

    @property
    def ridge(self) -> float:
        return PEAK_FLOPS_BF16 / HBM_BW

    @property
    def roofline_fraction(self) -> float:
        return min(1.0, self.ai / self.ridge)

    def to_row(self) -> Dict[str, float]:
        return {"hbm_bytes": self.hbm_bytes, "flops": self.flops,
                "ai_flops_per_byte": round(self.ai, 4),
                "roofline_fraction": round(self.roofline_fraction, 6)}


def pixel_cascade_roofline(batch: int, h: int, w: int, *, fused: bool
                           ) -> PixelRoofline:
    """Analytic HBM traffic + ops of one tick's pixel frontend.

    Both variants read the three (B, H, W, 3) int32 frames and write the
    final (B, H, W) mask.  The staged chain additionally round-trips the
    framediff and dilated masks through HBM — two extra full-frame writes
    and two extra reads — which is exactly the traffic the fused kernel
    (keeping its band on chip) deletes.  FLOPs are identical by
    construction (same stencil math, one implementation).
    """
    px = batch * h * w
    frames = 3 * px * 3 * PIXEL_BYTES          # three RGB int32 frames in
    mask = px * PIXEL_BYTES                    # final mask out
    flops = px * sum(PIXEL_FLOPS.values())
    if fused:
        return PixelRoofline("pixel_cascade_fused", frames + mask, flops)
    # staged: framediff out + dilate in/out + erode in (4 extra passes)
    return PixelRoofline("pixel_cascade_staged",
                         frames + mask + 4 * mask, flops)


def load_dryrun(out_dir: str, arch: str, shape: str, mesh: str
                ) -> Optional[Dict[str, Any]]:
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None
