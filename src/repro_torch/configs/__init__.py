"""Architecture registry of the port.

This slice carries the one architecture the pixel path runs: the CQ
classifier ``surveiledge-cls``.  The reference's assigned LLM
architectures (``--arch`` in its launchers) come with the LLM slice of the
port.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.surveiledge_cnn import CONFIG as _surveiledge
from repro_torch.models.config import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {_surveiledge.name: _surveiledge}


def get_config(name: str) -> ModelConfig:
    """The registered config ``name``; any other name raises
    ``NotImplementedError`` (the LLM architectures are not ported yet)."""
    if name not in REGISTRY:
        raise NotImplementedError(
            f"arch {name!r} is not in the port: only {sorted(REGISTRY)} is "
            f"ported; the LLM architectures come with the LLM slice of the "
            f"PyTorch port")
    return REGISTRY[name]
