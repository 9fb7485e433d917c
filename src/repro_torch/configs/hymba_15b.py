"""Hymba-1.5B: hybrid — parallel attention + mamba heads in every layer.
[arXiv:2411.13676]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    tie_embeddings=True,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,            # 50 ssm heads
    ssm_conv=4,
    ssm_chunk=256,
    ssm_ngroups=1,
    mlp_act="silu",
    norm_type="rmsnorm",
    rope_style="neox",
)
