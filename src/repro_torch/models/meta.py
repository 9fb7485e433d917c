"""Parameter metadata of every model family: shapes, logical axes, init.

Every parameter leaf is declared once as a :class:`ParamMeta` carrying its
shape, logical axis names and init rule, as in the reference's
``models/meta.py``; ``init_params`` materialises tensors from it.  Layer
parameters carry a leading ``stack`` axis of size ``num_layers`` (the
encoder's ``num_enc_layers``), so the port's parameter tree has the
reference's structure and shapes leaf for leaf (``bridge.params_from_numpy``
and ``distributed.quantize.quantize_tree`` rely on that).

The tree covers all six families: attention with optional QKV bias and
per-head qk RMSNorm, RMSNorm or LayerNorm (with its bias leaf), a SiLU-
gated or a GELU MLP, a sort-dispatched MoE (``moe`` in place of ``mlp``),
the Mamba-2 mixer (``ssm``), cross-attention and an encoder stack
(``cross``, ``norm_cross``, ``enc_layers``, ``enc_norm``) and an image
projection (``img_proj``).  What the model code cannot run raises where it
reads the setting.  The reference draws its init from a JAX PRNG key,
which torch cannot reproduce; ``init_params`` draws the same shapes and
distributions from a ``torch.Generator`` instead.
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
    init: str = "normal"       # normal | zeros | ones | a_log | dt_bias
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _stack(L: int):
    """(leading shape, leading axes) of a leaf stacked over ``L`` layers
    (none where ``L`` is 0)."""
    return ((L,), (STACK,)) if L else ((), ())


def _attn_meta(cfg: ModelConfig, L: int, cross: bool = False) -> Tree:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pre, preax = _stack(L)
    out_scale = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    t: Tree = {
        "wq": ParamMeta(pre + (D, H, hd), preax + ("embed", "heads",
                                                   "head_dim")),
        "wk": ParamMeta(pre + (D, KV, hd), preax + ("embed", "kv_heads",
                                                    "head_dim")),
        "wv": ParamMeta(pre + (D, KV, hd), preax + ("embed", "kv_heads",
                                                    "head_dim")),
        "wo": ParamMeta(pre + (H, hd, D), preax + ("heads", "head_dim",
                                                   "embed"),
                        scale=out_scale),
    }
    if cfg.attn_bias:
        t["bq"] = ParamMeta(pre + (H, hd), preax + ("heads", "head_dim"),
                            init="zeros")
        t["bk"] = ParamMeta(pre + (KV, hd), preax + ("kv_heads", "head_dim"),
                            init="zeros")
        t["bv"] = ParamMeta(pre + (KV, hd), preax + ("kv_heads", "head_dim"),
                            init="zeros")
    if cfg.qk_norm and not cross:
        t["q_norm"] = ParamMeta(pre + (hd,), preax + ("head_dim",),
                                init="ones")
        t["k_norm"] = ParamMeta(pre + (hd,), preax + ("head_dim",),
                                init="ones")
    return t


def _norm_meta(cfg: ModelConfig, L: int = 0) -> Tree:
    D = cfg.d_model
    pre, preax = _stack(L)
    t: Tree = {"scale": ParamMeta(pre + (D,), preax + ("embed",),
                                  init="ones")}
    if cfg.norm_type == "layernorm":
        t["bias"] = ParamMeta(pre + (D,), preax + ("embed",), init="zeros")
    return t


def _mlp_meta(cfg: ModelConfig, L: int) -> Tree:
    """``wi``/``wo``, and the gate ``wg`` only under SiLU (a GELU MLP is
    not gated)."""
    D, F = cfg.d_model, cfg.d_ff
    pre, preax = _stack(L)
    out_scale = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    t: Tree = {
        "wi": ParamMeta(pre + (D, F), preax + ("embed", "mlp")),
        "wo": ParamMeta(pre + (F, D), preax + ("mlp", "embed"),
                        scale=out_scale),
    }
    if cfg.mlp_act == "silu":
        t["wg"] = ParamMeta(pre + (D, F), preax + ("embed", "mlp"))
    return t


def _moe_meta(cfg: ModelConfig, L: int) -> Tree:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    pre, preax = _stack(L)
    out_scale = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    t: Tree = {
        "router": ParamMeta(pre + (D, E), preax + ("embed", None)),
        "wi": ParamMeta(pre + (E, D, F), preax + ("experts", "embed", "mlp")),
        "wo": ParamMeta(pre + (E, F, D), preax + ("experts", "mlp", "embed"),
                        scale=out_scale),
    }
    if cfg.mlp_act == "silu":
        t["wg"] = ParamMeta(pre + (E, D, F), preax + ("experts", "embed",
                                                      "mlp"))
    return t


def _ssm_meta(cfg: ModelConfig, L: int) -> Tree:
    """The Mamba-2 mixer: in-projections, depthwise convs, the per-head
    time constants (``a_log``, ``dt_bias``, their own init rules), the
    skip, the gated norm and the out-projection."""
    D, d_in = cfg.d_model, cfg.ssm_d_inner
    nh, G, N, W = cfg.ssm_heads, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv
    pre, preax = _stack(L)
    out_scale = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    return {
        "wz": ParamMeta(pre + (D, d_in), preax + ("embed", "ssm_inner")),
        "wx": ParamMeta(pre + (D, d_in), preax + ("embed", "ssm_inner")),
        "wb": ParamMeta(pre + (D, G, N), preax + ("embed", "groups",
                                                  "ssm_state")),
        "wc": ParamMeta(pre + (D, G, N), preax + ("embed", "groups",
                                                  "ssm_state")),
        "wdt": ParamMeta(pre + (D, nh), preax + ("embed", "ssm_heads")),
        "conv_x": ParamMeta(pre + (W, d_in), preax + ("conv_w", "ssm_inner")),
        "conv_b": ParamMeta(pre + (W, G * N), preax + ("conv_w", None)),
        "conv_c": ParamMeta(pre + (W, G * N), preax + ("conv_w", None)),
        "a_log": ParamMeta(pre + (nh,), preax + ("ssm_heads",), init="a_log"),
        "d_skip": ParamMeta(pre + (nh,), preax + ("ssm_heads",), init="ones"),
        "dt_bias": ParamMeta(pre + (nh,), preax + ("ssm_heads",),
                             init="dt_bias"),
        "gate_norm": ParamMeta(pre + (d_in,), preax + ("ssm_inner",),
                               init="ones"),
        "wo": ParamMeta(pre + (d_in, D), preax + ("ssm_inner", "embed"),
                        scale=out_scale),
    }


def layer_meta(cfg: ModelConfig) -> Tree:
    """Metadata of the (stacked) decoder layer: attention and/or the SSM
    mixer, cross-attention under an encoder, then a MoE or an MLP where
    ``d_ff`` is set."""
    L = cfg.num_layers
    t: Tree = {"norm1": _norm_meta(cfg, L)}
    if cfg.has_attn:
        t["attn"] = _attn_meta(cfg, L)
    if cfg.has_ssm:
        t["ssm"] = _ssm_meta(cfg, L)
    if cfg.is_encdec:
        t["cross"] = _attn_meta(cfg, L, cross=True)
        t["norm_cross"] = _norm_meta(cfg, L)
    if cfg.d_ff > 0:
        t["norm2"] = _norm_meta(cfg, L)
        if cfg.is_moe:
            t["moe"] = _moe_meta(cfg, L)
        else:
            t["mlp"] = _mlp_meta(cfg, L)
    return t


def encoder_layer_meta(cfg: ModelConfig) -> Tree:
    L = cfg.num_enc_layers
    return {"norm1": _norm_meta(cfg, L), "attn": _attn_meta(cfg, L),
            "norm2": _norm_meta(cfg, L), "mlp": _mlp_meta(cfg, L)}


def model_meta(cfg: ModelConfig) -> Tree:
    """Full parameter tree metadata for one model."""
    D, V = cfg.d_model, cfg.vocab_size
    t: Tree = {
        "embed": ParamMeta((V, D), ("vocab", "embed"), scale=1.0 / math.sqrt(D)),
        "layers": layer_meta(cfg),
        "final_norm": _norm_meta(cfg),
        "cls_head": {
            "w": ParamMeta((D, cfg.num_query_classes), ("embed", None)),
            "b": ParamMeta((cfg.num_query_classes,), (None,), init="zeros"),
        },
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamMeta((D, V), ("embed", "vocab"))
    if cfg.is_encdec:
        t["enc_layers"] = encoder_layer_meta(cfg)
        t["enc_norm"] = _norm_meta(cfg)
    if cfg.num_img_tokens > 0:
        t["img_proj"] = ParamMeta((1024, D), ("vit", "embed"))
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
    dev = gen.device
    if meta.init == "zeros":
        return torch.zeros(meta.shape, device=dev)
    if meta.init == "ones":
        return torch.ones(meta.shape, device=dev)
    if meta.init == "a_log":
        # A in [1, 16), a_log = log(A); the S4/Mamba convention A = -exp(a_log)
        u = torch.rand(meta.shape, generator=gen, device=dev)
        return torch.log(1.0 + 15.0 * u)
    if meta.init == "dt_bias":
        # dt ~ logU[1e-3, 1e-1]; bias = softplus^{-1}(dt)
        u = torch.rand(meta.shape, generator=gen, device=dev)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3))
                       + math.log(1e-3))
        return torch.log(torch.expm1(dt))
    return torch.randn(meta.shape, generator=gen, device=dev) * meta.scale


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Tree:
    """A seeded f32 parameter tree with the reference's shapes and init
    rules, on ``generator``'s device: a N(0, scale) draw from
    ``generator`` for every normal leaf and a uniform draw for each SSM
    time constant (``a_log``, ``dt_bias``), in ``leaves`` order; ones and
    zeros where the reference has them."""
    return tree_map(lambda m: _init_leaf(m, generator),
                    _in_leaf_order(model_meta(cfg)))


def abstract_params(cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                    device="meta") -> Tree:
    """The parameter tree as storage-free tensors of ``dtype`` on the
    ``meta`` device (or, under a ``FakeTensorMode``, fake ones on
    ``device``) — the dry-run's stand-in for ShapeDtypeStructs."""
    return tree_map(lambda m: torch.empty(m.shape, dtype=dtype,
                                          device=device), model_meta(cfg))


def param_count(cfg: ModelConfig) -> int:
    """Elements over every leaf of ``model_meta(cfg)``."""
    return sum(math.prod(m.shape) for _, m in leaves(model_meta(cfg)))


def _in_leaf_order(tree: Tree) -> Tree:
    """``tree`` rebuilt with sorted keys, so ``tree_map`` visits (and
    draws for) the leaves in ``leaves`` order."""
    return {k: _in_leaf_order(tree[k]) if isinstance(tree[k], dict)
            else tree[k] for k in sorted(tree)}
