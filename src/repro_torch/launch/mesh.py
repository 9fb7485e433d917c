"""Production, host and fleet meshes, and the per-device constants of the
roofline.

A :class:`Mesh` is a small description: axis names and sizes, the device
type, and (for the fleet mesh) the device each position runs on.  The
sharding rules (``distributed.sharding``) read only its ``shape``, so
they need no process group; ``Mesh.device_mesh`` builds the
``torch.distributed.device_mesh.DeviceMesh`` over ranks 0..n-1 when one
is needed, and that needs an initialized default process group of n
ranks (``launch.multihost.initialize``, or the dry-run's fake group).

The production meshes keep the reference's shapes, so the sharding specs
compare one for one:

  single:  (16, 16)      axes ("data", "model")        256 devices
  multi:   (2, 16, 16)   axes ("pod", "data", "model") 512 devices
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch

# Per-device constants of the roofline: NVIDIA H100 SXM5 (80 GB HBM3).
# Spec-sheet values from NVIDIA's data sheets, not measurements.
#: dense bf16 tensor-core FLOP/s (H100 SXM5 data sheet, without sparsity)
PEAK_FLOPS_BF16 = 989.4e12
#: HBM3 bytes/s (H100 SXM5 data sheet)
HBM_BW = 3.35e12
#: bytes/s per GPU, one direction, of the link the 16-wide "model" axis
#: crosses.  An 8-GPU NVLink node holds half of it, so the axis spans two
#: nodes and its slowest hop is the inter-node network: one 400 Gb/s
#: ConnectX-7 InfiniBand port per GPU (DGX H100 data sheet) = 50 GB/s.
LINK_BW = 50e9


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes over ``device_type`` devices; ``devices``, on
    a fleet mesh, names the device of each position (shards may share
    one)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device_type: str = "cuda"
    devices: Tuple[str, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes "
                             f"{self.axis_sizes}")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` has it."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @functools.cached_property
    def device_mesh(self):
        """The ``DeviceMesh`` over ranks 0..size-1 in row-major order;
        needs an initialized default process group of ``size`` ranks."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        if not dist.is_initialized():
            raise RuntimeError("Mesh.device_mesh needs an initialized "
                               "process group (launch.multihost."
                               "initialize)")
        if dist.get_world_size() != self.size:
            raise RuntimeError(f"a mesh of {self.size} devices over a "
                               f"process group of {dist.get_world_size()}")
        ranks = torch.arange(self.size).reshape(self.axis_sizes)
        return DeviceMesh(self.device_type, ranks,
                          mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, device_type)


def make_host_mesh(device_type: str = "cuda") -> Mesh:
    """One device, (data=1, model=1): the card (or, asked, the CPU)."""
    return Mesh(("data", "model"), (1, 1), device_type)


def _visible_devices(device_type: str) -> Tuple[str, ...]:
    """The devices of a type this process sees: every card, or the CPU."""
    if device_type == "cuda":
        return tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    if device_type == "cpu":
        return ("cpu",)
    raise ValueError(f"device type {device_type!r}: expected cuda or cpu")


def make_fleet_mesh(num_devices: Optional[int] = None, *,
                    device_type: str = "cuda") -> Mesh:
    """1-D ("fleet",) mesh over the row axis of the scan-superstep slab.

    Rows are mutually independent, so each shard runs the superstep
    kernel on its own rows with no collective
    (``distributed.sharding.fleet_specs``).  ``num_devices`` shards
    (default: one per visible device of ``device_type``) go round-robin
    over the visible devices, so shards may share one: that is how one
    card, or the CPU, runs a split fleet."""
    visible = _visible_devices(device_type)
    if not visible:
        raise RuntimeError(f"no {device_type} device visible")
    n = len(visible) if num_devices is None else int(num_devices)
    if n < 1:
        raise ValueError(f"num_devices={num_devices}: expected >= 1")
    return Mesh(("fleet",), (n,), device_type,
                tuple(visible[i % len(visible)] for i in range(n)))


def chips(mesh: Mesh) -> int:
    return mesh.size
