"""c4ai-command-r-v01: 35B dense, GQA kv=8, no-bias, parallel block, LayerNorm.
[hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    attn_bias=False,
    parallel_block=True,       # attn & mlp computed in parallel from one norm
    tie_embeddings=True,       # command-r ties input/output embeddings
    mlp_act="silu",
    norm_type="layernorm",
    rope_style="neox",
    rope_theta=8000000.0,
)
