"""Checkpointing to npz (no external deps).

Saves a parameter or ``TrainState`` tree as flat npz entries keyed by
tree path, spelled as ``jax.tree_util.keystr`` spells them: ``['layers']
['attn']['wq']`` for dict keys, ``.params``/``.opt``/``.m`` for
NamedTuple fields, ``[0]`` for sequence indices, so a file written by
the reference's ``checkpoint.save`` restores here and the other way
round.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                   path: str = "") -> Any:
    """``tree`` rebuilt with ``fn(path, leaf)`` at every leaf; ``None`` is
    an empty subtree."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f),
                                           f"{path}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _flatten(tree: Any) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    _map_with_path(flat.__setitem__, tree)
    return flat


def _numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any, step: Optional[int] = None) -> None:
    """Write ``tree`` (tensors on any device, numpy arrays or numbers) to
    ``path`` through a temporary file and ``os.replace``, so a reader
    never sees a half-written checkpoint; ``step`` goes in as
    ``__step__``."""
    arrays = {k: _numpy(v) for k, v in _flatten(tree).items()}
    if step is not None:
        arrays["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), dtype)).dtype


def restore(path: str, like: Any) -> Any:
    """Rebuild a tree shaped like ``like`` from ``path``.

    ``like``'s leaves are tensors, or specs with a ``shape`` and a torch
    or numpy ``dtype``.  Each entry must have its leaf's shape (else
    ``ValueError``); it is cast to the leaf's dtype and put on the leaf's
    device (the CPU for a spec or a tensor on the ``meta`` device)."""
    with np.load(path) as data:
        def load(key, ref):
            if key not in data:
                raise ValueError(f"{path} has no entry {key!r}")
            arr = data[key]
            if arr.shape != tuple(ref.shape):
                raise ValueError(f"{path} entry {key!r}: shape {arr.shape}, "
                                 f"want {tuple(ref.shape)}")
            dev = getattr(ref, "device", None)
            if not isinstance(dev, torch.device) or dev.type == "meta":
                dev = torch.device("cpu")
            return torch.from_numpy(arr).to(device=dev,
                                            dtype=_torch_dtype(ref.dtype))
        return _map_with_path(load, like)


def latest_step(path: str) -> Optional[int]:
    """The ``step`` saved with ``path``'s checkpoint; ``None`` where there
    is no file or no step."""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        if "__step__" in data:
            return int(data["__step__"])
    return None
