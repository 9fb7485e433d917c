"""Multi-process bring-up: one process per device.

Every process runs the same program; ``initialize`` joins it to the
default ``torch.distributed`` process group, from torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``) or from explicit arguments: NCCL over the cards, gloo on
the CPU.  Then ``launch.mesh.make_production_mesh(...).device_mesh``
builds the mesh over the group's ranks.  The dry-run
(``launch.dryrun``) does not use this module: it runs in a fake group of
its own.

  torchrun --nproc-per-node 8 -m repro_torch.launch.multihost
  python -m repro_torch.launch.multihost --coordinator localhost:29500 \\
      --num-processes 1 --process-id 0
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.mesh import make_production_mesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> torch.device:
    """Join the default process group and return this process's device.

    ``coordinator`` ("host:port") with ``num_processes`` and
    ``process_id``; without it, torchrun's environment.  On the card each
    process takes ``cuda:<LOCAL_RANK>`` (the rank modulo the cards seen
    where no local rank is given) and the NCCL backend; ``device="cpu"``
    takes the gloo backend."""
    dev = resolve_device(device)
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        init, world, rank = f"tcp://{coordinator}", num_processes, process_id
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                               "RANK") if k not in os.environ]
        if missing:
            raise RuntimeError(f"no coordinator given and no torchrun "
                               f"environment (missing {missing})")
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), \
            int(os.environ["RANK"])
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init, world_size=world,
                                rank=rank, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank)
    return dev


def describe() -> str:
    devs = (f"{torch.cuda.device_count()} local cards"
            if torch.cuda.is_available() else "no card")
    return (f"process {dist.get_rank()}/{dist.get_world_size()} "
            f"({dist.get_backend()}) — {devs}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator",
                    default=os.environ.get("COORDINATOR_ADDRESS"))
    ap.add_argument("--num-processes", type=int,
                    default=int(os.environ.get("NUM_PROCESSES", "0")) or None)
    ap.add_argument("--process-id", type=int,
                    default=int(os.environ.get("PROCESS_ID", "-1")))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    initialize(args.coordinator, args.num_processes,
               args.process_id if args.process_id >= 0 else None,
               device=args.device)
    try:
        print(describe())
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=resolve_device(
                                        args.device).type)
        print(f"mesh: {mesh.shape}")
        if dist.get_world_size() == mesh.size:
            print(f"device mesh: {mesh.device_mesh}")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
