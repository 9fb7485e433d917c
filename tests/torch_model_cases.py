"""Reference weights carried into the port, shared by the port's model
tests (serving, every model family, int8, speculative decoding).

The reference draws a model's weights (``repro.models.meta.init_params``)
and ``bridge.params_from_numpy`` carries them across as numpy.  The
reference initialises QKV biases (of attention, cross-attention and the
encoder) and LayerNorm biases to zeros and the qk-norm scales to ones,
which would hide a port that drops any of them, so the bridged trees
perturb whichever of those leaves they have first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import meta as JM
from repro_torch import bridge
from repro_torch.configs import get_config


def perturbed(tree, seed):
    """The reference's tree with nonzero QKV biases (of attention,
    cross-attention and the encoder) and LayerNorm biases, and qk-norm
    scales away from one, wherever the tree has those leaves (the dense
    trees' leaves first, in the order they always took)."""
    rng = np.random.default_rng(seed)
    layers, enc = tree["layers"], tree.get("enc_layers", {})
    for attn in (layers.get("attn", {}), layers.get("cross", {}),
                 enc.get("attn", {})):
        for name in ("bq", "bk", "bv"):
            if name in attn:
                attn[name] = (0.1 * rng.standard_normal(attn[name].shape)
                              ).astype(np.float32)
    attn = layers.get("attn", {})
    for name in ("q_norm", "k_norm"):
        if name in attn:
            attn[name] = (1.0 + 0.2 * rng.standard_normal(attn[name].shape)
                          ).astype(np.float32)
    for norm in (layers["norm1"], layers.get("norm2", {}),
                 tree["final_norm"], layers.get("norm_cross", {}),
                 tree.get("enc_norm", {}), enc.get("norm1", {}),
                 enc.get("norm2", {})):
        if "bias" in norm:
            norm["bias"] = (0.1 * rng.standard_normal(norm["bias"].shape)
                            ).astype(np.float32)
    return tree


def port_cfg(ref_cfg):
    """The port's config of the same name and variant."""
    base = ref_cfg.name.replace("-smoke", "").replace("-edge", "")
    full = get_config(base)
    cfg = full.edge_variant() if ref_cfg.name.endswith("-edge") \
        else full.reduced()
    return dataclasses.replace(cfg, attn_impl=ref_cfg.attn_impl,
                               num_layers=ref_cfg.num_layers,
                               kv_cache_dtype=ref_cfg.kv_cache_dtype,
                               logit_softcap=ref_cfg.logit_softcap)


def bridged(ref_cfg, key, seed):
    """(reference params, port params): the same perturbed f32 weights."""
    tree = perturbed(jax.tree.map(np.asarray, JM.init_params(ref_cfg, key)),
                     seed)
    return (jax.tree.map(jnp.asarray, tree),
            bridge.params_from_numpy(port_cfg(ref_cfg), tree))


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def as_long(x):
    return torch.from_numpy(np.asarray(x)).long()
