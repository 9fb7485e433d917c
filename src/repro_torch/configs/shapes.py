"""Assigned input shapes of the dry-run, and shape-only stand-ins for
every model input.

The reference's ``configs/shapes.py``: ``input_specs`` returns tensors
on the ``meta`` device (shapes and dtypes, no storage) where the
reference returns ShapeDtypeStructs; under a ``FakeTensorMode`` pass
``device="cuda"`` (or ``"cpu"``) to get fake tensors on that device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # 'train' | 'prefill' | 'decode'
    # decode shapes: seq_len is the KV-cache/context length, one new token.


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# long-context decode for attention archs uses a sliding window
# (sub-quadratic); SSM archs need no window.
LONG_CONTEXT_WINDOW = 8192


def shape_for(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def decode_window(cfg: ModelConfig, shape: InputShape) -> Optional[int]:
    """Effective attention window for a (cfg, shape) pair."""
    if shape.name == "long_500k" and cfg.has_attn:
        return LONG_CONTEXT_WINDOW
    return cfg.sliding_window


def attn_cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    w = decode_window(cfg, shape)
    if w is not None:
        return min(w, shape.seq_len)
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype: torch.dtype = torch.bfloat16,
                device="meta") -> Dict[str, torch.Tensor]:
    """Storage-free stand-ins for every model input.

    train:   tokens + labels (+ stub frontend embeddings)
    prefill: tokens (+ stub frontend embeddings)
    decode:  token (the cache comes from ``make_cache(abstract=True)``)
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def mk(shp, dt):
        return torch.empty(shp, dtype=dt, device=device)

    specs: Dict[str, torch.Tensor] = {}
    s_text = S
    if cfg.num_img_tokens > 0 and shape.kind != "decode":
        s_text = S - cfg.num_img_tokens
        specs["img_embeds"] = mk((B, cfg.num_img_tokens, 1024), dtype)
    if cfg.is_encdec and shape.kind != "decode":
        specs["audio_frames"] = mk((B, cfg.enc_seq, cfg.d_model), dtype)
    if shape.kind == "train":
        specs["tokens"] = mk((B, s_text), i32)
        specs["labels"] = mk((B, s_text), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = mk((B, s_text), i32)
    else:  # decode
        specs["token"] = mk((B,), i32)
    return specs
