"""Parameter metadata of the dense models: shapes, logical axes, init.

Every parameter leaf is declared once as a :class:`ParamMeta` carrying its
shape, logical axis names and init rule, as in the reference's
``models/meta.py``; ``init_params`` materialises tensors from it.  Layer
parameters carry a leading ``stack`` axis of size ``num_layers``, so the
port's parameter tree has the reference's structure and shapes leaf for
leaf (``bridge.params_from_numpy`` relies on that).

The port carries the dense family: attention with optional QKV bias and
per-head qk RMSNorm, 'neox' or chatglm's '2d' RoPE, a SiLU-gated MLP,
RMSNorm or LayerNorm (with its bias leaf), sequential or command-r's
parallel block, an int8 KV cache.  That covers the CQ classifier and the
serving path's qwen1.5, qwen3, chatglm3 and command-r models;
``check_dense`` refuses any other config.  The reference draws its init from a JAX PRNG key, which torch
cannot reproduce; ``init_params`` draws the same shapes and scales from a
``torch.Generator`` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig

STACK = "stack"

Tree = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def check_dense(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is in the dense subset
    the port runs.  ``sliding_window`` and ``logit_softcap`` pass: as in
    the reference, the model code never reads the first (a window comes
    in through ``window=``), and the chunked attention applies the
    second."""
    outside = [what for what, ok in (
        (f"family {cfg.family!r}", cfg.family == "dense"),
        ("MoE", not cfg.is_moe),
        ("SSM", not cfg.has_ssm),
        ("encoder-decoder", not cfg.is_encdec),
        ("image prefix", cfg.num_img_tokens == 0),
        (f"rope_style {cfg.rope_style!r}", cfg.rope_style in ("neox", "2d",
                                                             "none")),
        (f"norm_type {cfg.norm_type!r}", cfg.norm_type in ("rmsnorm",
                                                           "layernorm")),
        (f"mlp_act {cfg.mlp_act!r}", cfg.mlp_act == "silu"),
        ("d_ff 0", cfg.d_ff > 0),
        (f"attn_impl {cfg.attn_impl!r}", cfg.attn_impl in ("chunked",
                                                           "flash")),
        (f"kv_cache_dtype {cfg.kv_cache_dtype!r}",
         cfg.kv_cache_dtype in ("model", "int8")),
    ) if not ok]
    if outside:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(outside)} is outside the dense subset "
            f"the PyTorch port runs (the rest comes with later slices)")


def _attn_meta(cfg: ModelConfig, L: int) -> Tree:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out_scale = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    t: Tree = {
        "wq": ParamMeta((L, D, H, hd), (STACK, "embed", "heads", "head_dim")),
        "wk": ParamMeta((L, D, KV, hd),
                        (STACK, "embed", "kv_heads", "head_dim")),
        "wv": ParamMeta((L, D, KV, hd),
                        (STACK, "embed", "kv_heads", "head_dim")),
        "wo": ParamMeta((L, H, hd, D), (STACK, "heads", "head_dim", "embed"),
                        scale=out_scale),
    }
    if cfg.attn_bias:
        t["bq"] = ParamMeta((L, H, hd), (STACK, "heads", "head_dim"),
                            init="zeros")
        t["bk"] = ParamMeta((L, KV, hd), (STACK, "kv_heads", "head_dim"),
                            init="zeros")
        t["bv"] = ParamMeta((L, KV, hd), (STACK, "kv_heads", "head_dim"),
                            init="zeros")
    if cfg.qk_norm:
        t["q_norm"] = ParamMeta((L, hd), (STACK, "head_dim"), init="ones")
        t["k_norm"] = ParamMeta((L, hd), (STACK, "head_dim"), init="ones")
    return t


def _norm_meta(cfg: ModelConfig, L: Optional[int] = None) -> Tree:
    D = cfg.d_model
    pre, preax = ((L,), (STACK,)) if L else ((), ())
    t: Tree = {"scale": ParamMeta(pre + (D,), preax + ("embed",),
                                  init="ones")}
    if cfg.norm_type == "layernorm":
        t["bias"] = ParamMeta(pre + (D,), preax + ("embed",), init="zeros")
    return t


def _mlp_meta(cfg: ModelConfig, L: int) -> Tree:
    D, F = cfg.d_model, cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    return {
        "wi": ParamMeta((L, D, F), (STACK, "embed", "mlp")),
        "wo": ParamMeta((L, F, D), (STACK, "mlp", "embed"), scale=out_scale),
        "wg": ParamMeta((L, D, F), (STACK, "embed", "mlp")),
    }


def model_meta(cfg: ModelConfig) -> Tree:
    """Full parameter tree metadata for one dense model."""
    check_dense(cfg)
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    t: Tree = {
        "embed": ParamMeta((V, D), ("vocab", "embed"), scale=1.0 / math.sqrt(D)),
        "layers": {"norm1": _norm_meta(cfg, L), "attn": _attn_meta(cfg, L),
                   "norm2": _norm_meta(cfg, L), "mlp": _mlp_meta(cfg, L)},
        "final_norm": _norm_meta(cfg),
        "cls_head": {
            "w": ParamMeta((D, cfg.num_query_classes), ("embed", None)),
            "b": ParamMeta((cfg.num_query_classes,), (None,), init="zeros"),
        },
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamMeta((D, V), ("embed", "vocab"))
    return t


def leaves(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``("a/b/c", leaf)`` pairs in sorted-key depth-first order (the order
    a JAX pytree flattens a dict in)."""
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from leaves(val, path)
        else:
            yield path, val


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """The same nested dict with ``fn`` applied to every leaf, and to the
    matching leaves of ``rest`` (trees of the same structure) beside it."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _init_leaf(meta: ParamMeta, gen: torch.Generator) -> torch.Tensor:
    if meta.init == "zeros":
        return torch.zeros(meta.shape)
    if meta.init == "ones":
        return torch.ones(meta.shape)
    return torch.randn(meta.shape, generator=gen) * meta.scale


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Tree:
    """A seeded f32 CPU parameter tree with the reference's shapes and
    scales: a N(0, scale) draw from ``generator`` (a CPU generator) for
    every normal leaf in ``leaves`` order, ones and zeros where the
    reference has them."""
    return tree_map(lambda m: _init_leaf(m, generator),
                    _in_leaf_order(model_meta(cfg)))


def _in_leaf_order(tree: Tree) -> Tree:
    """``tree`` rebuilt with sorted keys, so ``tree_map`` visits (and
    draws for) the leaves in ``leaves`` order."""
    return {k: _in_leaf_order(tree[k]) if isinstance(tree[k], dict)
            else tree[k] for k in sorted(tree)}
