"""Model configuration for every architecture family the framework supports.

A single ``ModelConfig`` dataclass describes dense / MoE / SSM / hybrid /
encoder-decoder (audio) / VLM backbones.  Copied from the reference
package (it is framework-free); architecture files under
``repro_torch.configs`` instantiate it and register themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Family = str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'audio' | 'vlm'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # --- identity -----------------------------------------------------------
    name: str
    family: Family
    source: str = ""                    # citation (hf:/arXiv: per assignment)

    # --- transformer trunk --------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                   # 0 -> d_model // num_heads
    d_ff: int = 1024                    # per-expert width for MoE
    vocab_size: int = 32000
    max_seq_len: int = 1 << 20

    # --- attention flavour --------------------------------------------------
    attn_bias: bool = False             # QKV bias (qwen1.5, chatglm, whisper)
    qk_norm: bool = False               # per-head RMSNorm on q,k (qwen3)
    rope_style: str = "neox"            # 'neox' | '2d' (chatglm half-dim) | 'none'
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # None -> full causal
    parallel_block: bool = False        # attn & mlp in parallel (command-r)
    logit_softcap: float = 0.0

    # --- norms / act ---------------------------------------------------------
    norm_type: str = "rmsnorm"          # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-5
    mlp_act: str = "silu"               # 'silu' (gated) | 'gelu' (non-gated)
    tie_embeddings: bool = False

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0                # 0 -> dense MLP
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0                  # 0 -> no ssm path
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # --- encoder-decoder (audio) --------------------------------------------
    num_enc_layers: int = 0             # >0 -> enc-dec model (whisper)
    enc_seq: int = 1500                 # fixed encoder frame count (stub frontend)

    # --- VLM -----------------------------------------------------------------
    num_img_tokens: int = 0             # >0 -> image-embedding prefix (stub ViT)

    # --- serving ------------------------------------------------------------
    kv_cache_dtype: str = "model"       # 'model' (= activations) | 'int8'
    attn_impl: str = "chunked"          # 'chunked' (pure-XLA) | 'flash'
                                        # (Pallas fused kernel; TPU target)

    # --- cascade (SurveilEdge) head -----------------------------------------
    num_query_classes: int = 2          # CQ-specific classifier head width

    # ------------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.num_heads and self.num_heads % self.num_kv_heads != 0:
            raise ValueError(f"{self.name}: num_heads % num_kv_heads != 0")

    # derived ----------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def has_attn(self) -> bool:
        return self.family != "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.num_enc_layers > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    # parameter counting (analytic; for roofline MODEL_FLOPS = 6 N D) --------
    def param_count(self, active_only: bool = False) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
        n = V * D                                   # embed
        if not self.tie_embeddings:
            n += D * V                              # lm head
        per_layer = 0
        if self.has_attn:
            per_layer += D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.has_ssm:
            d_in = self.ssm_d_inner
            conv_ch = d_in + 2 * self.ssm_ngroups * self.ssm_state
            per_layer += D * (2 * d_in + 2 * self.ssm_ngroups * self.ssm_state
                              + self.ssm_heads)     # in_proj
            per_layer += self.ssm_conv * conv_ch    # conv
            per_layer += d_in * D                   # out_proj
        if self.is_moe:
            e = self.top_k if active_only else self.num_experts
            gate = 3 if self.mlp_act == "silu" else 2
            per_layer += e * gate * D * F + D * self.num_experts
        elif F > 0:
            gate = 3 if self.mlp_act == "silu" else 2
            per_layer += gate * D * F
        n += L * per_layer
        if self.is_encdec:                          # encoder stack + cross attn
            enc_layer = D * H * hd * 4 + (3 if self.mlp_act == "silu" else 2) * D * F
            cross = D * H * hd * 4
            n += self.num_enc_layers * enc_layer + L * cross
        return n

    # reduced variants --------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        if self.num_heads:
            H = min(self.num_heads, 4)
            KV = max(1, min(self.num_kv_heads, H))
            while H % KV:
                KV -= 1
            d = min(self.d_model, 256)
            hd = max(8, d // H)
            d = H * hd
        else:  # attention-free (ssm)
            H, KV, hd = 0, 1, 0
            d = min(self.d_model, 256)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            num_enc_layers=min(self.num_enc_layers, 2),
            d_model=d,
            num_heads=H,
            num_kv_heads=KV,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_headdim=min(self.ssm_headdim, 32) if self.has_ssm else self.ssm_headdim,
            ssm_state=min(self.ssm_state, 32) if self.has_ssm else 0,
            ssm_chunk=32,
            enc_seq=min(self.enc_seq, 24),
            num_img_tokens=min(self.num_img_tokens, 8),
        )

    def edge_variant(self) -> "ModelConfig":
        """CQ-specific ('edge') variant: the lightweight cascade front model.

        Plays MobileNet-v2's role from the paper: same family, 2 layers,
        narrow width, fine-tuned per (cluster x query).
        """
        cfg = self.reduced()
        return dataclasses.replace(cfg, name=self.name + "-edge")
