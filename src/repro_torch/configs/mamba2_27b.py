"""Mamba2-2.7B: attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    num_heads=0,               # attention-free
    num_kv_heads=1,
    head_dim=0,
    d_ff=0,                    # no MLP: mamba2 blocks only
    vocab_size=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,            # 80 heads
    ssm_conv=4,
    ssm_chunk=256,
    ssm_ngroups=1,
    norm_type="rmsnorm",
    rope_style="none",
)
