"""InternVL2-1B: InternViT (STUBBED — input_specs provides patch embeddings)
+ Qwen2-0.5B-family language backbone. [arXiv:2404.16821]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    num_img_tokens=256,        # stub ViT patch embeddings, projected
    attn_bias=True,
    tie_embeddings=True,
    mlp_act="silu",
    norm_type="rmsnorm",
    rope_style="neox",
    rope_theta=1000000.0,
)
