"""Deterministic, host-sharded token data pipeline.

Each process materializes only its shard of the global batch: the global
batch of B sequences splits over ``num_hosts`` processes, and
``host_batches`` builds the ``host_id``-th block in numpy, the
reference's arrays bit for bit.  ``to_device`` puts a block on the
process's card; ``global_shard`` makes it this rank's part of the
global batch on a mesh (one process, one card).  Synthetic-but-learnable streams (affine next-token rule + noise)
keep loss curves meaningful without external data.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    noise: float = 0.3          # fraction of random (non-rule) next tokens


def _rule_stream(rng: np.random.Generator, n: int, s: int,
                 vocab: int, noise: float):
    base = rng.integers(0, vocab, size=(n, s + 1), dtype=np.int64)
    shifted = (base[:, :-1] * 31 + 17) % vocab
    mask = rng.random((n, s)) < noise
    tokens = base[:, :-1].astype(np.int32)
    labels = np.where(mask, base[:, 1:], shifted).astype(np.int32)
    return tokens, labels


def host_batches(cfg: ModelConfig, lc: LoaderConfig, *,
                 host_id: int = 0, num_hosts: int = 1
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Per-host shard of the global batch, deterministic in (step, host):
    ``tokens`` and ``labels`` (B / num_hosts, seq_len less the image
    prefix) int32, plus ``img_embeds`` or ``audio_frames`` (f32) where the
    model takes them."""
    if lc.global_batch % num_hosts:
        raise ValueError(f"global batch {lc.global_batch} does not split "
                         f"over {num_hosts} hosts")
    per_host = lc.global_batch // num_hosts
    s_text = lc.seq_len - (cfg.num_img_tokens or 0)
    step = 0
    while True:
        rng = np.random.default_rng(
            (lc.seed * 1_000_003 + step) * 4096 + host_id)
        tokens, labels = _rule_stream(rng, per_host, s_text,
                                      cfg.vocab_size, lc.noise)
        batch: Dict[str, np.ndarray] = {"tokens": tokens, "labels": labels}
        if cfg.num_img_tokens:
            batch["img_embeds"] = rng.normal(
                0, 0.1, (per_host, cfg.num_img_tokens, 1024)).astype(np.float32)
        if cfg.is_encdec:
            batch["audio_frames"] = rng.normal(
                0, 0.1, (per_host, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        yield batch
        step += 1


def global_shard(batch: Dict[str, np.ndarray], shardings, device
                 ) -> Dict[str, torch.Tensor]:
    """Each rank's host block as its part of the global batch.

    ``shardings`` is one ``distributed.sharding.NamedSharding`` or a dict
    of them by key (``batch_specs``).  Under an initialized process group
    every leaf becomes the DTensor whose local shard is this rank's block
    (``DTensor.from_local`` with the batch placement; no collective):
    ranks at one coordinate of the data axes pass the same block, which
    ``host_batches(host_id=that coordinate, num_hosts=data_size)`` gives.
    With no process group (one process) it is a plain ``to_device``."""
    import torch.distributed as dist
    local = to_device(batch, device)
    if not dist.is_initialized():
        return local
    from repro_torch.distributed.sharding import from_local
    out = {}
    for k, v in local.items():
        sh = shardings[k] if isinstance(shardings, dict) else shardings
        out[k] = from_local(v, sh, sh.global_shape(v.shape))
    return out


def to_device(batch: Dict[str, np.ndarray],
              device) -> Dict[str, torch.Tensor]:
    """A host block as tensors on ``device``, dtypes kept."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
