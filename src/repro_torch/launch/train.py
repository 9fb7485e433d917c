"""Training launcher.

Trains any assigned architecture (``--reduced``: its smoke-scale variant)
on synthetic token streams: the card unless ``--device cpu``.  The flags
are the reference launcher's, plus ``--device``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --steps 200 --batch 8 --seq 128 --device cpu

``--mesh`` trains on a device mesh with the code path the dry-run runs:
parameters and AdamW state are DTensors placed by the train rules
(``distributed.sharding.param_shardings(mode="train")``), each rank's
batch block becomes its part of the global batch (``data.loader.
global_shard``) and the step takes ``ActCtx``.  ``host`` is a one-process,
one-device (1, 1) mesh; ``single`` and ``multi`` the production meshes
(256 and 512 devices) under ``launch.multihost.initialize`` (torchrun's
environment).  Without ``--mesh`` the step runs on plain tensors on one
device (the reference's launcher always builds a mesh; its default is
``host``).

Weights come from ``torch.Generator(device).manual_seed(0)`` (the
reference draws from ``PRNGKey(0)``; the two frameworks draw different
numbers from one seed).  Every layer is rematerialized in the backward
pass, and the learning rate follows a cosine schedule after
``max(steps // 10, 1)`` warmup steps.
"""
from __future__ import annotations

import argparse
import socket
import time
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs import get_config
from repro_torch.data.loader import (LoaderConfig, global_shard,
                                     host_batches, to_device)
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import mesh as MESH
from repro_torch.launch import multihost
from repro_torch.models import meta as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, schedules
from repro_torch.train import steps as ST


def init_state(cfg: ModelConfig, device,
               mesh: Optional[MESH.Mesh] = None) -> ST.TrainState:
    """Seed-0 weights drawn on ``device``, zero AdamW state, step 0; on a
    ``mesh``, DTensors placed by the train rules (every rank draws the
    whole tree from the one seed and keeps its shard)."""
    dev = resolve_device(device)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    if mesh is not None:
        params = SH.distribute_tree(params, SH.param_shardings(
            cfg, mesh, "train"))
    return ST.TrainState(params, adamw.init(params),
                         torch.zeros((), dtype=torch.int32, device=dev))


def make_step(cfg: ModelConfig, *, lr: float, steps: int,
              microbatches: int = 1, ctx=None,
              remat_policy: Optional[str] = None) -> Callable:
    """The launcher's train step: AdamW at ``lr`` under the cosine
    schedule for ``steps`` steps, every layer rematerialized (keeping the
    products ``remat_policy`` names); ``ctx`` an ``ActCtx`` on a mesh."""
    opt_cfg = adamw.AdamWConfig(lr=lr, schedule=schedules.cosine_with_warmup(
        max(steps // 10, 1), steps))
    return ST.make_train_step(cfg, opt_cfg, remat=True,
                              microbatches=microbatches, ctx=ctx,
                              remat_policy=remat_policy)


def batches(cfg: ModelConfig, batch: int, seq: int, device,
            mesh: Optional[MESH.Mesh] = None
            ) -> Iterator[Dict[str, torch.Tensor]]:
    """The loader's seed-0 stream of (``batch``, ``seq``) blocks on
    ``device``: one process, the whole global batch; on a ``mesh``, this
    rank's host block as its part of the global batch."""
    if mesh is None:
        for block in host_batches(cfg, LoaderConfig(global_batch=batch,
                                                    seq_len=seq)):
            yield to_device(block, device)
        return
    host, hosts = SH.data_index(mesh)
    for block in host_batches(cfg, LoaderConfig(global_batch=batch,
                                                seq_len=seq),
                              host_id=host, num_hosts=hosts):
        yield global_shard(block, SH.batch_specs(cfg, mesh, batch, block),
                           device)


def free_port() -> int:
    """A free TCP port on localhost, for a one-process group."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def open_mesh(kind: str, device) -> tuple:
    """(mesh, this process's device) after joining its process group:
    ``host`` a one-process group of its own, ``single``/``multi`` the
    production mesh from torchrun's environment."""
    if kind == "host":
        dev = multihost.initialize(f"localhost:{free_port()}", 1, 0,
                                   device=device)
        return MESH.make_host_mesh(dev.type), dev
    dev = multihost.initialize(device=device)
    return MESH.make_production_mesh(multi_pod=kind == "multi",
                                      device_type=dev.type), dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default=None, help="train on a device mesh")
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

    mesh = ctx = None
    if args.mesh:
        mesh, dev = open_mesh(args.mesh, dev)
        ctx = SH.ActCtx(cfg, mesh)
        print(f"[train] mesh {args.mesh}: {mesh.shape}")
    try:
        state = init_state(cfg, dev, mesh)
        step_fn = make_step(cfg, lr=args.lr, steps=args.steps,
                            microbatches=args.microbatches, ctx=ctx)
        data = batches(cfg, args.batch, args.seq, dev, mesh)
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
            CK.save(args.checkpoint, SH.full_tree(state.params),
                    step=args.steps)
            print(f"[train] checkpoint -> {args.checkpoint}")
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    final = float(metrics["loss"])
    print(f"[train] done: final loss {final:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
