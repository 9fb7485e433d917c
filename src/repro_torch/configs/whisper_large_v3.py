"""Whisper-large-v3: enc-dec audio transformer; conv/mel frontend STUBBED
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=32,             # decoder
    num_enc_layers=32,         # encoder
    enc_seq=1500,              # 30s of audio after conv frontend (stub)
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    attn_bias=True,
    tie_embeddings=True,
    mlp_act="gelu",            # non-gated GELU MLP
    norm_type="layernorm",
    rope_style="none",         # sinusoidal absolute positions
)
