"""Training launcher.

Trains any assigned architecture (``--reduced``: its smoke-scale variant)
on synthetic token streams on one device: the card unless ``--device
cpu``.  The flags are the reference launcher's, less ``--mesh`` (the
multi-device slice is not ported yet), plus ``--device``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --steps 200 --batch 8 --seq 128 --device cpu

Weights come from ``torch.Generator(device).manual_seed(0)`` (the
reference draws from ``PRNGKey(0)``; the two frameworks draw different
numbers from one seed).  Every layer is rematerialized in the backward
pass, and the learning rate follows a cosine schedule after
``max(steps // 10, 1)`` warmup steps.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Iterator

import torch

from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs import get_config
from repro_torch.data.loader import LoaderConfig, host_batches, to_device
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import meta as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, schedules
from repro_torch.train import steps as ST


def init_state(cfg: ModelConfig, device) -> ST.TrainState:
    """Seed-0 weights drawn on ``device``, zero AdamW state, step 0."""
    dev = resolve_device(device)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    return ST.TrainState(params, adamw.init(params),
                         torch.zeros((), dtype=torch.int32, device=dev))


def make_step(cfg: ModelConfig, *, lr: float, steps: int,
              microbatches: int = 1) -> Callable:
    """The launcher's train step: AdamW at ``lr`` under the cosine
    schedule for ``steps`` steps, every layer rematerialized."""
    opt_cfg = adamw.AdamWConfig(lr=lr, schedule=schedules.cosine_with_warmup(
        max(steps // 10, 1), steps))
    return ST.make_train_step(cfg, opt_cfg, remat=True,
                              microbatches=microbatches)


def batches(cfg: ModelConfig, batch: int, seq: int,
            device) -> Iterator[Dict[str, torch.Tensor]]:
    """The loader's seed-0 stream of (``batch``, ``seq``) blocks on
    ``device``: one process, the whole global batch."""
    for block in host_batches(cfg, LoaderConfig(global_batch=batch,
                                                seq_len=seq)):
        yield to_device(block, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"B={args.batch} S={args.seq} steps={args.steps}")

    state = init_state(cfg, dev)
    step_fn = make_step(cfg, lr=args.lr, steps=args.steps,
                        microbatches=args.microbatches)
    data = batches(cfg, args.batch, args.seq, dev)
    t0 = time.time()
    for step in range(args.steps):
        state, metrics = step_fn(state, next(data))
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            tps = args.batch * args.seq * (step + 1) / (time.time() - t0)
            print(f"  step {step:5d} loss={loss:8.4f} "
                  f"gnorm={float(metrics['grad_norm']):8.3f} "
                  f"tok/s={tps:9.0f}")
    if args.checkpoint:
        CK.save(args.checkpoint, state.params, step=args.steps)
        print(f"[train] checkpoint -> {args.checkpoint}")
    final = float(metrics["loss"])
    print(f"[train] done: final loss {final:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
