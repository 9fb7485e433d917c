"""ChatGLM3-6B: dense, RoPE-2d (half-dim interleaved), extreme GQA kv=2.
[arXiv:2406.12793]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    source="arXiv:2406.12793",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    attn_bias=True,            # chatglm uses QKV bias
    mlp_act="silu",
    norm_type="rmsnorm",
    rope_style="2d",           # rotary applied to half of head_dim, interleaved
    rope_theta=10000.0,
)
