"""The paper's own cascade pair, transliterated to this framework.

The paper deploys MobileNet-v2 (edge, CQ-specific) + ResNet-152 (cloud).  In
this framework the 'cloud' high-accuracy classifier is a small dense
transformer over patch tokens and the 'edge' model is its `edge_variant()` —
the cascade machinery (core/) is identical.  Copied from the reference
package's ``configs/surveiledge_cnn.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="surveiledge-cls",
    family="dense",
    source="paper:SurveilEdge (MobileNet-v2 / ResNet-152 cascade analogue)",
    num_layers=8,
    d_model=256,
    num_heads=8,
    num_kv_heads=8,
    head_dim=32,
    d_ff=1024,
    vocab_size=4096,           # patch-token codebook
    num_query_classes=12,      # object classes (car, person, moped, ...)
    mlp_act="silu",
    norm_type="rmsnorm",
    rope_style="neox",
)
