"""Architecture registry of the port.

The CQ classifier ``surveiledge-cls`` (the pixel path) and the four dense
LLMs the serving path runs: ``qwen1.5-0.5b`` (QKV bias, MHA, the
serving launcher's default ``--arch``), ``qwen3-8b`` (qk-norm, GQA
32:8), ``chatglm3-6b`` (QKV bias, '2d' RoPE, GQA 32:2) and
``command-r-35b`` (parallel block, LayerNorm, tied embeddings, GQA 64:8).
Each config is a copy of the reference package's file of the same name.  The reference's other assigned architectures (MoE, SSM, hybrid,
encoder-decoder, VLM) are not ported yet.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm3
from repro_torch.configs.command_r_35b import CONFIG as _command_r
from repro_torch.configs.qwen15_05b import CONFIG as _qwen15
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3
from repro_torch.configs.surveiledge_cnn import CONFIG as _surveiledge
from repro_torch.models.config import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (_qwen15, _qwen3, _chatglm3, _command_r,
                        _surveiledge)}


def get_config(name: str) -> ModelConfig:
    """The registered config ``name``; any other name raises
    ``NotImplementedError`` (the rest of the reference's architectures
    are not ported yet)."""
    if name not in REGISTRY:
        raise NotImplementedError(
            f"arch {name!r} is not in the port: only {sorted(REGISTRY)} are "
            f"ported; the MoE, SSM, hybrid, encoder-decoder and VLM "
            f"architectures come with later slices of the PyTorch port")
    return REGISTRY[name]
