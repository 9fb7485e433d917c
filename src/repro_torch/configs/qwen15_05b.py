"""Qwen1.5-0.5B: dense, QKV bias, MHA (kv=16). [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    attn_bias=True,            # QKV bias
    tie_embeddings=True,
    mlp_act="silu",
    norm_type="rmsnorm",
    rope_style="neox",
    rope_theta=1000000.0,
)
