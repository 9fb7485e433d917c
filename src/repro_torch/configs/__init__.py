"""Architecture registry of the port: one module per assigned architecture.

The CQ classifier ``surveiledge-cls`` (the pixel path) and the ten
``ASSIGNED`` LLMs the serving path runs, in the reference's order:
phi3.5-moe and granite-moe (sort-dispatched MoE), qwen1.5-0.5b (QKV
bias, the serving launcher's default ``--arch``), mamba2 (Mamba-2 SSD
blocks only), command-r (parallel LayerNorm block), whisper (encoder-
decoder, stub audio frames), hymba (attention and SSM heads in parallel),
chatglm3 ('2d' RoPE), qwen3 (qk-norm) and internvl2 (a stub image-
embedding prefix).  Each config is a copy of the reference package's
file of the same name; every config cites its source and is selectable
by id via ``--arch <id>`` in the launchers.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm3
from repro_torch.configs.command_r_35b import CONFIG as _command_r
from repro_torch.configs.granite_moe_1b import CONFIG as _granite
from repro_torch.configs.hymba_15b import CONFIG as _hymba
from repro_torch.configs.internvl2_1b import CONFIG as _internvl2
from repro_torch.configs.mamba2_27b import CONFIG as _mamba2
from repro_torch.configs.phi35_moe_42b import CONFIG as _phi35
from repro_torch.configs.qwen15_05b import CONFIG as _qwen15
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3
from repro_torch.configs.surveiledge_cnn import CONFIG as _surveiledge
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.models.config import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (_phi35, _qwen15, _mamba2, _command_r, _whisper,
                        _hymba, _chatglm3, _granite, _qwen3, _internvl2,
                        _surveiledge)}

ASSIGNED: List[str] = [
    "phi3.5-moe-42b-a6.6b",
    "qwen1.5-0.5b",
    "mamba2-2.7b",
    "command-r-35b",
    "whisper-large-v3",
    "hymba-1.5b",
    "chatglm3-6b",
    "granite-moe-1b-a400m",
    "qwen3-8b",
    "internvl2-1b",
]


def get_config(name: str) -> ModelConfig:
    """The registered config ``name``; any other name raises
    ``NotImplementedError``."""
    if name not in REGISTRY:
        raise NotImplementedError(
            f"arch {name!r} is not in the port; available: "
            f"{sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs() -> List[str]:
    return list(ASSIGNED)
