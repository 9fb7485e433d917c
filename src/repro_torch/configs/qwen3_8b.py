"""Qwen3-8B: dense, qk_norm (per-head RMSNorm on q,k), GQA kv=8. [hf:Qwen/Qwen3-8B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    attn_bias=False,
    mlp_act="silu",
    norm_type="rmsnorm",
    rope_style="neox",
    rope_theta=1000000.0,
)
